"""Architecture registry of the port: config lookup, model construction and
parameter counting, for the reference's ten architecture ids.
"""
from __future__ import annotations

import importlib
import math

from repro_torch.core.accessors import QuantizedAccessor

from .config import ModelConfig
from .layers import ParamSpec
from .transformer import Model

# arch id -> family, as in the reference's configs, in the reference's order
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
ARCH_IDS = list(ARCH_FAMILIES)
EXPERT_LEAVES = ("w_gate", "w_up", "w_down")  # the leaves of a "moe" dict with an expert dim


def _module_name(arch_id: str) -> str:
    return arch_id.replace("-", "_").replace(".", "_")


def get_config(arch_id: str, *, smoke: bool = False) -> ModelConfig:
    if arch_id not in ARCH_FAMILIES:
        raise KeyError(f"unknown architecture {arch_id!r}")
    mod = importlib.import_module(f"repro_torch.configs.{_module_name(arch_id)}")
    return mod.smoke_config() if smoke else mod.config()


def build_model(cfg: ModelConfig, *, quantized: bool = False, device=None) -> Model:
    """The model for ``cfg`` on ``device`` (CUDA unless the caller names one);
    ``quantized`` stores the MLP weights as int8 with one scale per (row,
    128-block), and the MoE experts' along their last dim, as the
    reference's serving weights."""
    quant = QuantizedAccessor(cfg.param_dtype, bits=8, block=128) if quantized else None
    return Model(cfg, quant=quant, device=device)


def _spec_leaves(tree, expert=False):
    """(ParamSpec, whether it has an expert dim) for every leaf of a spec tree."""
    if isinstance(tree, ParamSpec):
        yield tree, expert
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _spec_leaves(v, expert or (k in EXPERT_LEAVES and "router" in tree))
    else:
        for v in tree:
            yield from _spec_leaves(v, expert)


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact count from the spec tree (the reference's); with ``active_only``
    the expert weights count at the routed fraction top_k / E (integer
    division of their total, as the reference)."""
    total = expert_total = 0
    for spec, expert in _spec_leaves(Model(cfg, device="cpu").param_specs()):
        n = math.prod(spec.shape)
        if expert and active_only and cfg.n_experts:
            expert_total += n
        else:
            total += n
    return total + expert_total * cfg.top_k // max(cfg.n_experts, 1)
