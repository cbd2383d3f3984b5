"""kimi-k2-1t-a32b — trillion-parameter MoE, 384 experts top-8, fine-grained
(d_ff=2048 per expert). [arXiv:2501.kimi2 per assignment table]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="kimi-k2-1t-a32b", family="moe",
        n_layers=61, d_model=7168, vocab=163840,
        n_heads=64, n_kv_heads=8, d_head=112, d_ff=2048,
        n_experts=384, top_k=8,
        mlp_act="swiglu", norm="rmsnorm", rope_theta=50000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="kimi-smoke", family="moe",
        n_layers=2, d_model=64, vocab=512, vocab_pad_to=128,
        n_heads=4, n_kv_heads=2, d_head=16, d_ff=32,
        n_experts=8, top_k=2,
        mlp_act="swiglu", norm="rmsnorm", rope_theta=50000.0,
    )
