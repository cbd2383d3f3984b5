"""Models of the port: the dense GQA decoders (qwen2-0.5b, llama3.2-1b,
qwen2.5-3b, granite-8b), the MoE decoders (dbrx-132b, kimi-k2-1t-a32b),
Mamba-2 (mamba2-780m), the RG-LRU / local-attention hybrid
(recurrentgemma-2b), the encoder-decoder (whisper-large-v3) and the vision
model with gated cross-attention layers (llama-3.2-vision-90b)."""
from .bridge import from_jax_params
from .config import ModelConfig
from .registry import ARCH_IDS, build_model, count_params, get_config
from .transformer import (
    DecBlock, DenseBlock, Model, MoEBlock, RecBlock, RGGroup, SSMBlock, VisGroup, block_program,
)

__all__ = [
    "ARCH_IDS",
    "DecBlock",
    "DenseBlock",
    "Model",
    "ModelConfig",
    "MoEBlock",
    "RGGroup",
    "RecBlock",
    "SSMBlock",
    "VisGroup",
    "block_program",
    "build_model",
    "count_params",
    "from_jax_params",
    "get_config",
]
