"""Dense decoder models of the port (first slice: qwen2-0.5b)."""
from .bridge import from_jax_params
from .config import ModelConfig
from .registry import ARCH_IDS, build_model, get_config
from .transformer import DenseBlock, Model

__all__ = [
    "ARCH_IDS",
    "DenseBlock",
    "Model",
    "ModelConfig",
    "build_model",
    "from_jax_params",
    "get_config",
]
