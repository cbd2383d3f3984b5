"""whisper-large-v3 — enc-dec audio backbone; the conv frontend is stubbed:
callers feed precomputed 1500-frame embeddings (``batch_inputs["frames"]``).
[arXiv:2212.04356]

As in the reference, RoPE replaces whisper's learned positional embeddings
(the decoder shapes served exceed whisper's 448-position table).
"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3", family="encdec",
        n_layers=32, n_enc_layers=32, d_model=1280, vocab=51866,
        n_heads=20, n_kv_heads=20, d_ff=5120,
        mlp_act="gelu", norm="layernorm",
        enc_seq=1500, rope_theta=10000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="whisper-smoke", family="encdec",
        n_layers=2, n_enc_layers=2, d_model=64, vocab=512, vocab_pad_to=128,
        n_heads=4, n_kv_heads=4, d_ff=128,
        mlp_act="gelu", norm="layernorm",
        enc_seq=12, rope_theta=10000.0,
    )
