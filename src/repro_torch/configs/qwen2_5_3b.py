"""qwen2.5-3b — GQA with QKV bias. [hf:Qwen/Qwen2.5-3B]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-3b", family="dense",
        n_layers=36, d_model=2048, vocab=151936,
        n_heads=16, n_kv_heads=2, d_ff=11008,
        qkv_bias=True, mlp_act="swiglu", norm="rmsnorm", rope_theta=1000000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="qwen2.5-smoke", family="dense",
        n_layers=2, d_model=64, vocab=512, vocab_pad_to=128,
        n_heads=4, n_kv_heads=2, d_ff=128,
        qkv_bias=True, mlp_act="swiglu", norm="rmsnorm", rope_theta=1000000.0,
    )
