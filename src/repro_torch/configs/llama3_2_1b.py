"""llama3.2-1b — small llama3 (head_dim 64). [hf:meta-llama/Llama-3.2-1B]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-1b", family="dense",
        n_layers=16, d_model=2048, vocab=128256,
        n_heads=32, n_kv_heads=8, d_ff=8192,
        mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True, rope_theta=500000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="llama3.2-smoke", family="dense",
        n_layers=2, d_model=64, vocab=512, vocab_pad_to=128,
        n_heads=4, n_kv_heads=2, d_ff=128,
        mlp_act="swiglu", norm="rmsnorm", tie_embeddings=True, rope_theta=500000.0,
    )
