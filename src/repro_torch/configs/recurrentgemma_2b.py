"""recurrentgemma-2b — RG-LRU + local attention, 1:2 pattern (26 layers =
(rec,rec,local_attn) x 8 + rec x 2). MQA (kv=1), head_dim 256, GeGLU MLP.
[arXiv:2402.19427]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b", family="hybrid",
        n_layers=26, d_model=2560, vocab=256000,
        n_heads=10, n_kv_heads=1, d_head=256, d_ff=7680,
        pattern=("rec", "rec", "local_attn"), lru_width=2560, window=2048,
        conv_kernel=4,
        mlp_act="geglu", norm="rmsnorm", tie_embeddings=True, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="rg-smoke", family="hybrid",
        n_layers=5, d_model=64, vocab=512, vocab_pad_to=128,
        n_heads=4, n_kv_heads=1, d_head=16, d_ff=128,
        pattern=("rec", "rec", "local_attn"), lru_width=64, window=8,
        conv_kernel=4,
        mlp_act="geglu", norm="rmsnorm", tie_embeddings=True, rope_theta=10000.0,
    )
