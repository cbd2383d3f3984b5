"""mamba2-780m — SSD (state-space duality), attention-free. [arXiv:2405.21060]"""
from repro_torch.models.config import ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-780m", family="ssm",
        n_layers=48, d_model=1536, vocab=50280,
        d_ff=0, n_heads=0, n_kv_heads=0,
        ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_ngroups=1,
        ssm_chunk=128, conv_kernel=4,
        norm="rmsnorm", tie_embeddings=True,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name="mamba2-smoke", family="ssm",
        n_layers=2, d_model=64, vocab=512, vocab_pad_to=128,
        d_ff=0, n_heads=0, n_kv_heads=0,
        ssm_state=16, ssm_expand=2, ssm_headdim=16, ssm_ngroups=1,
        ssm_chunk=8, conv_kernel=4,
        norm="rmsnorm", tie_embeddings=True,
    )
