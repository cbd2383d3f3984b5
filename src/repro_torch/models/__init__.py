"""Models of the port: the dense GQA decoder (qwen2-0.5b), Mamba-2
(mamba2-780m) and the RG-LRU / local-attention hybrid (recurrentgemma-2b)."""
from .bridge import from_jax_params
from .config import ModelConfig
from .registry import ARCH_IDS, build_model, get_config
from .transformer import DenseBlock, Model, RecBlock, RGGroup, SSMBlock, block_program

__all__ = [
    "ARCH_IDS",
    "DenseBlock",
    "Model",
    "ModelConfig",
    "RGGroup",
    "RecBlock",
    "SSMBlock",
    "block_program",
    "build_model",
    "from_jax_params",
    "get_config",
]
