"""dbrx-132b — 16-expert top-4 fine-grained MoE. [hf:databricks/dbrx-base]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-132b", family="moe",
        n_layers=40, d_model=6144, vocab=100352,
        n_heads=48, n_kv_heads=8, d_ff=10752,
        n_experts=16, top_k=4,
        mlp_act="swiglu", norm="layernorm", rope_theta=500000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="dbrx-smoke", family="moe",
        n_layers=2, d_model=64, vocab=512, vocab_pad_to=128,
        n_heads=4, n_kv_heads=2, d_ff=96,
        n_experts=4, top_k=2,
        mlp_act="swiglu", norm="layernorm", rope_theta=500000.0,
    )
