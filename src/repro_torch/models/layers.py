"""Dense layers of the port: parameter specs and their init, rmsnorm, RoPE,
SwiGLU MLP, embedding and the tied LM head.

Port of the dense half of ``repro.models.layers``; weights keep the
reference's layouts (a dense linear is (d_in, d_out), applied as x @ w), so a
bridged parameter tree is a dtype/device copy. Quantized linears, sharding and
the other norms/activations wait for their slices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------------------------
# parameter specs and init (the reference's TensorSpec init scheme)
# ---------------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: shape, dtype and init name ("zeros" | "ones" | "embed" |
    "normal" | "fan_in"), as in the reference's TensorSpec."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "fan_in"


def init_param(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    """Draw one parameter: zeros / ones, normal(0.02) for "embed"/"normal", and
    normal(1/sqrt(shape[-2])) for "fan_in" (shape[-1] for a vector), drawn in
    f32 and cast — the reference's scheme. ``generator`` must live on
    ``device``."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init in ("embed", "normal"):
        std = 0.02
    elif spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.empty(spec.shape, dtype=torch.float32, device=device)
    x.normal_(0.0, std, generator=generator)
    return x.to(spec.dtype)


def init_tree(specs, generator: torch.Generator, device):
    """Initialize a nested dict/list of ParamSpecs, depth-first in key order."""
    if isinstance(specs, ParamSpec):
        return init_param(specs, generator, device)
    if isinstance(specs, dict):
        return {k: init_tree(v, generator, device) for k, v in specs.items()}
    return [init_tree(v, generator, device) for v in specs]


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), torch.float32, "ones")


def mlp_specs(cfg) -> Dict[str, ParamSpec]:
    if cfg.mlp_act != "swiglu":
        raise NotImplementedError(f"mlp_act {cfg.mlp_act!r}: only swiglu is ported")
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    return {
        "w_gate": ParamSpec((d, f), dt),
        "w_up": ParamSpec((d, f), dt),
        "w_down": ParamSpec((f, d), dt),
    }


def embed_specs(cfg) -> Dict[str, ParamSpec]:
    s = {"embedding": ParamSpec((cfg.vocab_padded, cfg.d_model), cfg.param_dtype, "embed")}
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_padded), cfg.param_dtype)
    return s


# ---------------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------------
def apply_linear(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x, w.to(x.dtype))


def apply_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    if cfg.norm != "rmsnorm":
        raise NotImplementedError(f"norm {cfg.norm!r}: only rmsnorm is ported")
    return apply_rmsnorm(x, p)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, T, D); positions: (T,) or (B, T) absolute positions. Rotates
    the half-split pairs (x[..., i], x[..., i + D/2]), as the reference does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions.float()[..., None] * freqs  # (T, D/2) or (B, T, D/2)
    ang = ang[None, None] if positions.dim() == 1 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_mlp(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    g = apply_linear(x, p["w_gate"])
    u = apply_linear(x, p["w_up"])
    h = F.silu(g.float()).to(x.dtype) * u
    return apply_linear(h, p["w_down"])


def apply_embed(p: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens.long()]


def apply_lm_head(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    w = p["embedding"].t() if cfg.tie_embeddings else p["lm_head"]
    logits = torch.matmul(x, w.to(x.dtype))
    vp = logits.shape[-1]
    if vp != cfg.vocab:  # mask padded vocab slots
        mask = torch.arange(vp, device=logits.device) < cfg.vocab
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    return logits
