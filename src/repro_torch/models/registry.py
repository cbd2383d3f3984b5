"""Architecture registry of the port: config lookup and model construction.

Only the architectures whose slice is ported resolve; every other id of the
reference's registry raises NotImplementedError naming the ROADMAP queue item
it waits for.
"""
from __future__ import annotations

import importlib

from repro_torch.core.accessors import QuantizedAccessor

from .config import ModelConfig
from .transformer import Model

# arch id -> family, as in the reference's configs
ARCH_FAMILIES = {
    "mamba2-780m": "ssm",
    "whisper-large-v3": "encdec",
    "dbrx-132b": "moe",
    "kimi-k2-1t-a32b": "moe",
    "granite-8b": "dense",
    "qwen2-0.5b": "dense",
    "qwen2.5-3b": "dense",
    "llama3.2-1b": "dense",
    "llama-3.2-vision-90b": "vlm",
    "recurrentgemma-2b": "hybrid",
}
PORTED = ("qwen2-0.5b", "llama3.2-1b", "qwen2.5-3b", "granite-8b", "dbrx-132b",
          "kimi-k2-1t-a32b", "mamba2-780m", "recurrentgemma-2b")
ARCH_IDS = list(PORTED)


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    if arch_id not in PORTED:
        family = ARCH_FAMILIES.get(arch_id)
        if family is None:
            raise KeyError(f"unknown architecture {arch_id!r}")
        raise NotImplementedError(
            f"{arch_id} ({family}) is not ported yet: it waits for ROADMAP Queue 1 "
            f"item 4, the encoder-decoder and vision families (whisper, "
            f"llama-3.2-vision)"
        )
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.smoke_config() if smoke else mod.config()


def build_model(cfg: ModelConfig, *, quantized: bool = False, device=None) -> Model:
    """The model for ``cfg`` on ``device`` (CUDA unless the caller names one);
    ``quantized`` stores the MLP weights as int8 with one scale per (row,
    128-block), and the MoE experts' along their last dim, as the
    reference's serving weights."""
    quant = QuantizedAccessor(cfg.param_dtype, bits=8, block=128) if quantized else None
    return Model(cfg, quant=quant, device=device)
