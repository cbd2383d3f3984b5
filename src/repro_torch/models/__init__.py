"""Models of the port: the dense GQA decoder (qwen2-0.5b) and Mamba-2
(mamba2-780m)."""
from .bridge import from_jax_params
from .config import ModelConfig
from .registry import ARCH_IDS, build_model, get_config
from .transformer import DenseBlock, Model, SSMBlock, block_program

__all__ = [
    "ARCH_IDS",
    "DenseBlock",
    "Model",
    "ModelConfig",
    "SSMBlock",
    "block_program",
    "build_model",
    "from_jax_params",
    "get_config",
]
