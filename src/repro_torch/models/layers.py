"""Dense layers of the port: parameter specs and their init, rmsnorm and
layernorm, RoPE, the gated MLP (SwiGLU, GeGLU) and the plain gelu MLP with
biases, embedding and the LM head.

Port of what the model families use of ``repro.models.layers``; weights keep the
reference's layouts (a dense linear is (d_in, d_out), applied as x @ w; a
quantized one is {"q", "scale"} stored output-major (d_out, d_in), applied
through ``kernels.ops.matmul``), so a bridged parameter tree is a
dtype/device copy. Sharding waits for its slice.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.accessors import QuantizedAccessor
from repro_torch.core.distributed import quantize_array
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------------
# parameter specs and init (the reference's TensorSpec init scheme)
# ---------------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: shape, dtype and init name ("zeros" | "ones" | "embed" |
    "normal" | "fan_in"), as in the reference's TensorSpec. With ``quant`` set
    the parameter is stored as that accessor's {"q", "scale"} buffers."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "fan_in"
    quant: Optional[QuantizedAccessor] = None


def init_param(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    """Draw one parameter: zeros / ones, normal(0.02) for "embed"/"normal", and
    normal(1/sqrt(shape[-2])) for "fan_in" (shape[-1] for a vector), drawn in
    f32 and cast — the reference's scheme; a quantized spec quantizes the f32
    draw (``quantize_array``). ``generator`` must live on ``device``."""
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
    if spec.quant is not None:
        return quantize_array(x, spec.quant)
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


def layernorm_specs(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), torch.float32, "ones"),
            "bias": ParamSpec((d,), torch.float32, "zeros")}


def norm_specs(cfg):
    """The block norm's parameters: {"scale", "bias"} for layernorm, an
    rmsnorm scale otherwise (the reference's dispatch)."""
    return layernorm_specs(cfg.d_model) if cfg.norm == "layernorm" else rmsnorm_spec(cfg.d_model)


def fit_quant(quant: Optional[QuantizedAccessor], d_in: int) -> Optional[QuantizedAccessor]:
    """The largest block <= quant.block out of (quant.block, 128, 64, 32),
    at least 16, that divides d_in; None (dense storage) when none does."""
    if quant is None:
        return None
    for b in (quant.block, 128, 64, 32):
        if b <= quant.block and d_in % b == 0 and b >= 16:
            return dataclasses.replace(quant, block=b)
    return None


def linear_spec(d_in: int, d_out: int, *, dtype, quant: Optional[QuantizedAccessor] = None,
                init: str = "fan_in") -> ParamSpec:
    """Weight spec. Dense storage: (d_in, d_out). Quantized storage:
    output-major (d_out, d_in) intN + per-(row, block) scales, the layout
    quant_matmul reads."""
    quant = fit_quant(quant, d_in)
    if quant is not None:
        return ParamSpec((d_out, d_in), dtype, init, quant)
    return ParamSpec((d_in, d_out), dtype, init)


GATED_ACTS = ("swiglu", "geglu")


def mlp_specs(cfg, quant: Optional[QuantizedAccessor] = None) -> Dict[str, ParamSpec]:
    """The MLP's weights: the gated MLP's (SwiGLU and GeGLU share the leaf
    names), or for any other ``mlp_act`` (whisper's "gelu") the plain MLP's
    w_up / w_down with f32 biases b_up / b_down, as in the reference."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_act in GATED_ACTS:
        return {
            "w_gate": linear_spec(d, f, dtype=dt, quant=quant),
            "w_up": linear_spec(d, f, dtype=dt, quant=quant),
            "w_down": linear_spec(f, d, dtype=dt, quant=quant),
        }
    return {
        "w_up": linear_spec(d, f, dtype=dt, quant=quant),
        "b_up": ParamSpec((f,), torch.float32, "zeros"),
        "w_down": linear_spec(f, d, dtype=dt, quant=quant),
        "b_down": ParamSpec((d,), torch.float32, "zeros"),
    }


def embed_specs(cfg) -> Dict[str, ParamSpec]:
    s = {"embedding": ParamSpec((cfg.vocab_padded, cfg.d_model), cfg.param_dtype, "embed")}
    if not cfg.tie_embeddings:
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_padded), cfg.param_dtype)
    return s


# ---------------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------------
def apply_linear(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., d_in) @ w: a dense (d_in, d_out) tensor, or quantized
    {"q", "scale"} buffers read as int8, the reference's default accessor."""
    if isinstance(w, dict):
        return ops.matmul(x, w, QuantizedAccessor(x.dtype, bits=8))
    return torch.matmul(x, w.to(x.dtype))


def apply_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def apply_layernorm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * scale + bias, mean and variance in f32,
    cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p) -> torch.Tensor:
    return apply_layernorm(x, p) if cfg.norm == "layernorm" else apply_rmsnorm(x, p)


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


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    """Gated (swiglu, geglu): act(x @ w_gate) * (x @ w_up) @ w_down, the
    activation in f32 (silu, or tanh-approximated gelu). Otherwise the plain
    MLP: gelu_tanh(x @ w_up + b_up) @ w_down + b_down, the gelu in f32 and
    each bias cast to x's dtype."""
    if cfg.mlp_act not in GATED_ACTS:
        h = apply_linear(x, p["w_up"]) + p["b_up"].to(x.dtype)
        h = gelu_tanh(h.float()).to(x.dtype)
        return apply_linear(h, p["w_down"]) + p["b_down"].to(x.dtype)
    act = F.silu if cfg.mlp_act == "swiglu" else gelu_tanh
    g = apply_linear(x, p["w_gate"])
    u = apply_linear(x, p["w_up"])
    h = act(g.float()).to(x.dtype) * u
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
