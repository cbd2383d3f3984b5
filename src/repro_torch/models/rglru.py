"""RG-LRU recurrent block (RecurrentGemma/Griffin) of the port: conv1d + gated
linear recurrence.

Port of ``repro.models.rglru``. Prefill computes the decay a and the input
term b eagerly, in the reference's cast order, and runs the recurrence
through ``kernels.ops.rglru_scan`` (the rglru_scan kernel on CUDA tensors,
and under grad ``rglru_scan.RGLRUScanFn``, its backward on the
rglru_scan_bwd kernel; a and b are f32 and contiguous, as the kernels take
them; the reference runs ``jax.lax.associative_scan``, the same function,
which is the kernel's plain version here). Decode is an O(1) state update in plain
PyTorch, as in the reference, writing the cache in place.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import ParamSpec, gelu_tanh
from .ssm import _causal_conv, conv_tail

RG_C = 8.0


def rglru_specs(cfg, *, quant=None) -> Dict[str, ParamSpec]:
    """One block's parameters; ``quant`` is accepted and unused, as in the
    reference (only the MLP is stored quantized)."""
    d, w = cfg.d_model, cfg.lru_width
    dt = cfg.param_dtype
    return {
        "w_x": ParamSpec((d, w), dt, logical_axes=("embed", "lru")),
        "w_y": ParamSpec((d, w), dt, logical_axes=("embed", "lru")),
        "conv_w": ParamSpec((cfg.conv_kernel, w), dt, "fan_in", logical_axes=(None, "lru")),
        "conv_b": ParamSpec((w,), torch.float32, "zeros", logical_axes=("lru",)),
        "w_input_gate": ParamSpec((w, w), dt, logical_axes=("lru", "lru_gate")),
        "b_input_gate": ParamSpec((w,), torch.float32, "zeros", logical_axes=("lru_gate",)),
        "w_a_gate": ParamSpec((w, w), dt, logical_axes=("lru", "lru_gate")),
        "b_a_gate": ParamSpec((w,), torch.float32, "zeros", logical_axes=("lru_gate",)),
        "a_param": ParamSpec((w,), torch.float32, "ones", logical_axes=("lru",)),
        "w_out": ParamSpec((w, d), dt, logical_axes=("lru", "embed")),
    }


def rglru_cache_specs(cfg, batch: int) -> Dict[str, ParamSpec]:
    """The decode state: the (B, W) f32 recurrence state and the last K - 1
    pre-conv rows."""
    w = cfg.lru_width
    return {
        "h": ParamSpec((batch, w), torch.float32, "zeros", logical_axes=("batch", "lru")),
        "conv": ParamSpec((batch, cfg.conv_kernel - 1, w), cfg.param_dtype, "zeros",
                          logical_axes=("batch", None, "lru")),
    }


def _gates(p, xc: torch.Tensor):
    """(input gate, a gate) pre-activations in xc's dtype."""
    ig = torch.matmul(xc, p["w_input_gate"].to(xc.dtype)) + p["b_input_gate"].to(xc.dtype)
    ag = torch.matmul(xc, p["w_a_gate"].to(xc.dtype)) + p["b_a_gate"].to(xc.dtype)
    return ig, ag


def _log_a(p, ag: torch.Tensor) -> torch.Tensor:
    """log a = -c * softplus(a_param) * sigmoid(a gate), f32."""
    return -RG_C * F.softplus(p["a_param"].float()) * torch.sigmoid(ag.float())


def _decay_and_input(p, xc: torch.Tensor, gates=None):
    """a = exp(log a) and b = sqrt(max(1 - a^2, 1e-12)) * sigmoid(i) * xc, f32
    (``gates`` the (input gate, a gate) pre-activations, else ``_gates``)."""
    ig, ag = gates if gates is not None else _gates(p, xc)
    a = torch.exp(_log_a(p, ag))
    gated = torch.sigmoid(ig.float()) * xc.float()
    return a, torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * gated


def _split_gates(p, xc: torch.Tensor, lm):
    """The gates of this rank's lru columns, where "lru" is split over
    "model": its rows of w_input_gate / w_a_gate times its columns of xc are
    a partial sum of the whole gate, reduce-scattered to its own columns;
    the replicated biases sliced to them."""
    w = xc.shape[-1]
    cols = slice(lm.model_rank * w, (lm.model_rank + 1) * w)
    ig = lm.scatter(torch.matmul(xc, p["w_input_gate"].to(xc.dtype)), -1)
    ag = lm.scatter(torch.matmul(xc, p["w_a_gate"].to(xc.dtype)), -1)
    return (ig + p["b_input_gate"][cols].to(xc.dtype),
            ag + p["b_a_gate"][cols].to(xc.dtype))


def apply_rglru(cfg, p, x: torch.Tensor, *, lm=None, initial_state=None,
                return_state: bool = False, impl: str = "auto"):
    """x (B, S, D) -> (B, S, D) [+ the decode cache {"h", "conv"}]. ``impl``
    picks the recurrence (kernels.ops.rglru_scan); ``initial_state`` (B, W)
    f32 is the kernel's h0, where the reference folds it into b_0.

    Inside a block map (``lm``) with "lru" split over "model" (the local
    w_x narrower than lru_width): x enters the split block, w_x / w_y are
    column-parallel, the conv, a_param and the recurrence run on the local
    columns with no collective, the gates are reduce-scattered
    (``_split_gates``) and w_out is row-parallel, summed over "model".
    ``initial_state`` is then the rank's columns, and ``return_state`` (the
    serving prefill) gives the cache whole on "model": h and the conv tail
    gathered over the columns."""
    split = lm is not None and lm.model is not None and p["w_x"].shape[-1] < cfg.lru_width
    if split:
        x = lm.enter(x)
    xb = torch.matmul(x, p["w_x"].to(x.dtype))
    yb = gelu_tanh(torch.matmul(x, p["w_y"].to(x.dtype)).float()).to(x.dtype)
    xc = _causal_conv(xb, p["conv_w"], p["conv_b"])
    a, b = _decay_and_input(p, xc, _split_gates(p, xc, lm) if split else None)
    h = ops.rglru_scan(a, b, initial_state=initial_state, impl=impl).to(x.dtype)
    out = torch.matmul(h * yb, p["w_out"].to(x.dtype))
    if split:
        out = lm.sum(out)
    if not return_state:
        return out
    h_last, tail = h[:, -1].float(), conv_tail(xb, cfg.conv_kernel)
    if split:
        h_last, tail = lm.gather(h_last.contiguous(), 1), lm.gather(tail.contiguous(), 2)
    return out, {"h": h_last, "conv": tail}


def rglru_whole(p, prefix: str = "") -> set:
    """The leaves of DTensor RG-LRU weights ``p`` a block map takes whole on
    "model": every leaf where "lru" is not split (each rank then runs the
    whole block); none where it is (the gate biases are replicated)."""
    from repro_torch.core.distributed import is_split

    return set() if is_split(p["w_x"], 1) else {prefix + k for k in p}


def rglru_partial(p, prefix: str = "") -> set:
    """The gate biases where "lru" is split: a rank's gradient covers the
    columns it slices."""
    from repro_torch.core.distributed import is_split

    return {prefix + "b_input_gate", prefix + "b_a_gate"} if is_split(p["w_x"], 1) else set()


def apply_rglru_decode(cfg, p, x: torch.Tensor, cache, pos, lm=None):
    """x (B, 1, D); cache {"h": (B, W) f32, "conv": (B, K - 1, W)}, updated IN
    PLACE -> (y (B, 1, D), cache). Inside a serving block map (``lm``) with
    "lru" split over "model", the rank's columns (the cache's "lru" columns
    too): w_x / w_y column-parallel, the gates reduce-scattered
    (``_split_gates``), w_out row-parallel and summed."""
    split = lm is not None and lm.model is not None and p["w_x"].shape[-1] < cfg.lru_width
    if split:
        x = lm.enter(x)
    xb = torch.matmul(x[:, 0], p["w_x"].to(x.dtype))  # (B, W)
    yb = gelu_tanh(torch.matmul(x[:, 0], p["w_y"].to(x.dtype)).float()).to(x.dtype)
    k = cfg.conv_kernel
    w = p["conv_w"]
    conv = p["conv_b"].float() + xb.float() * w[k - 1].float()
    for i in range(k - 1):
        conv = conv + cache["conv"][:, i].float() * w[i].float()
    xc = conv.to(x.dtype)
    a, b = _decay_and_input(p, xc, _split_gates(p, xc, lm) if split else None)
    h = a * cache["h"] + b
    out = torch.matmul(h.to(x.dtype) * yb, p["w_out"].to(x.dtype))[:, None, :]
    if split:
        out = lm.sum(out)
    cache["conv"].copy_(torch.cat([cache["conv"][:, 1:], xb[:, None].to(cache["conv"].dtype)],
                                  dim=1))
    cache["h"].copy_(h)
    return out, cache
