"""qwen2-0.5b — GQA with QKV bias. [arXiv:2407.10671]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-0.5b", family="dense",
        n_layers=24, d_model=896, vocab=151936,
        n_heads=14, n_kv_heads=2, d_ff=4864,
        qkv_bias=True, mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True, rope_theta=1000000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-smoke", family="dense",
        n_layers=2, d_model=64, vocab=512, vocab_pad_to=128,
        n_heads=4, n_kv_heads=2, d_ff=128,
        qkv_bias=True, mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True, rope_theta=1000000.0,
    )
