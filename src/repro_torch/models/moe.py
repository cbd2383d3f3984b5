"""Mixture-of-Experts block: top-k token-choice routing with capacity-based
dispatch.

Port of ``repro.models.moe``'s einsum path. The router runs in f32; each
token picks its top-k experts (ties to the lower expert id, as
``jax.lax.top_k``: ``ops.top_k_lower_id_first``) with renormalized gate
weights; a stable argsort over the chosen expert ids ranks each (token,
choice) within its expert, and the
first ``_capacity`` of an expert's entries are copied into an (E, C, D)
buffer, the rest dropped. The experts' SwiGLU products are batched over E
(``torch.bmm``: the reference computes them outside any Pallas kernel), and
the combine gathers each kept entry's output row back and sums the k choices
weighted by their gates. A Switch-style aux loss comes back beside the
output.

Every routed row takes capacity: the caller's padding and inactive decode
rows are routed like live ones, as in the reference, so the same rows are
dropped. The expert-parallel ``shard_map`` formulation is distribution
(ROADMAP Queue 1 item 6) and is not ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.accessors import QuantizedAccessor
from repro_torch.core.distributed import dequantize_array
from repro_torch.kernels import ops

from .layers import ParamSpec, fit_quant


def moe_specs(cfg, *, quant=None) -> Dict[str, ParamSpec]:
    """Router (D, E) f32; experts w_gate / w_up (E, D, F) and w_down (E, F,
    D) in the param dtype, or with ``quant`` int8 {"q", "scale"} blocked
    along the last dim (the reference's layout, not the 2-D linears'
    output-major one)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype

    def mk(shape):
        return ParamSpec(shape, dt, "fan_in", fit_quant(quant, shape[-1]))

    return {
        "router": ParamSpec((d, e), torch.float32, "fan_in"),
        "w_gate": mk((e, d, f)),
        "w_up": mk((e, d, f)),
        "w_down": mk((e, f, d)),
    }


def _capacity(cfg, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return -(-c // 8) * 8  # rounded up to 8, as the reference's sublane alignment


def _deq(wbufs, cfg) -> torch.Tensor:
    """Expert weights stored int8 {"q", "scale"}: dequantized at use, in the
    param dtype (the block is what the scales say: last dim / scale count)."""
    acc = QuantizedAccessor(cfg.param_dtype, bits=8,
                            block=wbufs["q"].shape[-1] // wbufs["scale"].shape[-1])
    return dequantize_array(wbufs, acc)


def _weight(w, cfg, dtype) -> torch.Tensor:
    return (_deq(w, cfg) if isinstance(w, dict) else w).to(dtype)


def apply_moe(cfg, p, x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (y (B, S, D) in x's dtype, aux f32 scalar)."""
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    cap = _capacity(cfg, t)
    xt = x.reshape(t, d)

    logits = xt.float() @ p["router"].float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, idx = ops.top_k_lower_id_first(probs, k)  # (T, k), ties to the lower id
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    # Switch aux loss: E * sum_e f_e * P_e (f_e the top-1 fraction)
    f_e = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(f_e * probs.mean(dim=0))

    # rank within expert: position in a stable sort over the expert ids
    eflat = idx.reshape(-1)  # (T * k,)
    order = torch.argsort(eflat, stable=True)
    sorted_e = eflat[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=x.device), side="left")
    ranks = torch.empty_like(eflat)
    ranks[order] = torch.arange(t * k, device=x.device) - starts[sorted_e]

    slot = eflat * cap + ranks
    valid = ranks < cap
    # dropped entries land in one extra row, thrown away
    safe_slot = torch.where(valid, slot, torch.full_like(slot, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[safe_slot] = xt.repeat_interleave(k, dim=0)
    buf = buf[:-1].reshape(e, cap, d)

    g = torch.bmm(buf, _weight(p["w_gate"], cfg, x.dtype))
    u = torch.bmm(buf, _weight(p["w_up"], cfg, x.dtype))
    h = (F.silu(g.float()) * u.float()).to(x.dtype)
    y = torch.bmm(h, _weight(p["w_down"], cfg, x.dtype)).reshape(e * cap, d)

    # combine: gather each kept entry's row back, weight by its gate
    gathered = y[torch.where(valid, slot, torch.zeros_like(slot))]  # (T * k, D)
    w = (gate_vals.reshape(-1) * valid.float()).to(x.dtype)
    out = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux

