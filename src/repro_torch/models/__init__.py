"""Models of the port: the dense GQA decoders (qwen2-0.5b, llama3.2-1b,
qwen2.5-3b, granite-8b), the MoE decoders (dbrx-132b, kimi-k2-1t-a32b),
Mamba-2 (mamba2-780m) and the RG-LRU / local-attention hybrid
(recurrentgemma-2b)."""
from .bridge import from_jax_params
from .config import ModelConfig
from .registry import ARCH_IDS, build_model, get_config
from .transformer import DenseBlock, Model, MoEBlock, RecBlock, RGGroup, SSMBlock, block_program

__all__ = [
    "ARCH_IDS",
    "DenseBlock",
    "Model",
    "ModelConfig",
    "MoEBlock",
    "RGGroup",
    "RecBlock",
    "SSMBlock",
    "block_program",
    "build_model",
    "from_jax_params",
    "get_config",
]
