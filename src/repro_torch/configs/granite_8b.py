"""granite-8b — llama-architecture code model. [arXiv:2405.04324]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="granite-8b", family="dense",
        n_layers=36, d_model=4096, vocab=49152,
        n_heads=32, n_kv_heads=8, d_ff=14336,
        mlp_act="swiglu", norm="rmsnorm", rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="granite-smoke", family="dense",
        n_layers=2, d_model=64, vocab=512, vocab_pad_to=128,
        n_heads=4, n_kv_heads=2, d_ff=128,
        mlp_act="swiglu", norm="rmsnorm", rope_theta=10000.0,
    )
