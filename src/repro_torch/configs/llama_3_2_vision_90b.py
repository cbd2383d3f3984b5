"""llama-3.2-vision-90b — text backbone with gated cross-attention image layers
(every 5th layer); the patch-embedding frontend is stubbed: callers feed
precomputed image-token embeddings (``batch_inputs["image_embeds"]``).
[hf:meta-llama/Llama-3.2-90B-Vision]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="llama-3.2-vision-90b", family="vlm",
        n_layers=100, d_model=8192, vocab=128256,
        n_heads=64, n_kv_heads=8, d_ff=28672,
        cross_every=5, n_img_tokens=6404,
        mlp_act="swiglu", norm="rmsnorm", rope_theta=500000.0,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="vision-smoke", family="vlm",
        n_layers=5, d_model=64, vocab=512, vocab_pad_to=128,
        n_heads=4, n_kv_heads=2, d_ff=128,
        cross_every=5, n_img_tokens=8,
        mlp_act="swiglu", norm="rmsnorm", rope_theta=500000.0,
    )
