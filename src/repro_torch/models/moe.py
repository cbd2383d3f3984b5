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
dropped.

On a mesh the block runs on local shards inside its block's map
(``moe_local``); with a "model" axis of more than one rank expert parallel
(``moe_ep_local``, the reference's ``shard_map`` formulation): tokens
sharded over the batch axes and replicated over "model", every model rank
routes alike and keeps the entries of its own ``E / ep`` experts (a
per-shard capacity), and one sum over "model" of the gate-weighted combine
merges them; without one the token shards are gathered and every rank runs
the einsum path on the whole batch (``moe_replicated_local``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.accessors import QuantizedAccessor
from repro_torch.core.distributed import dequantize_array, grad_scaled, group_mean, mesh_sizes
from repro_torch.kernels import ops

from .layers import ParamSpec, Sharder, fit_quant


def moe_specs(cfg, *, quant=None) -> Dict[str, ParamSpec]:
    """Router (D, E) f32; experts w_gate / w_up (E, D, F) and w_down (E, F,
    D) in the param dtype, or with ``quant`` int8 {"q", "scale"} blocked
    along the last dim (the reference's layout, not the 2-D linears'
    output-major one)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff
    dt = cfg.param_dtype

    def mk(shape, axes):
        return ParamSpec(shape, dt, "fan_in", fit_quant(quant, shape[-1]), axes)

    return {
        "router": ParamSpec((d, e), torch.float32, "fan_in", logical_axes=("embed", None)),
        "w_gate": mk((e, d, f), ("expert", "embed", "expert_ffn")),
        "w_up": mk((e, d, f), ("expert", "embed", "expert_ffn")),
        "w_down": mk((e, f, d), ("expert", "expert_ffn", "embed")),
    }


def _capacity(cfg, n_tokens: int) -> int:
    c = int(n_tokens * cfg.top_k * cfg.capacity_factor / cfg.n_experts) + 1
    return -(-c // 8) * 8  # rounded up to 8, as the reference's sublane alignment


def _route(cfg, xt: torch.Tensor, router: torch.Tensor):
    """Top-k routing of tokens xt (T, D): (renormalized gates (T, k), expert
    ids (T, k), the Switch aux loss E * sum_e f_e * P_e with f_e the top-1
    fraction, and each (token, choice)'s rank within its expert: its place in
    a stable sort over the expert ids)."""
    e, k = cfg.n_experts, cfg.top_k
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)  # (T, E)
    gate_vals, idx = ops.top_k_lower_id_first(probs, k)  # ties to the lower id
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    f_e = F.one_hot(idx[:, 0], e).float().mean(dim=0)
    aux = e * torch.sum(f_e * probs.mean(dim=0))
    eflat = idx.reshape(-1)  # (T * k,)
    order = torch.argsort(eflat, stable=True)
    sorted_e = eflat[order]
    starts = torch.searchsorted(sorted_e, torch.arange(e, device=xt.device), side="left")
    ranks = torch.empty_like(eflat)
    ranks[order] = torch.arange(eflat.numel(), device=xt.device) - starts[sorted_e]
    return gate_vals, eflat, aux, ranks


def _experts(cfg, p, buf: torch.Tensor, dtype) -> torch.Tensor:
    """The SwiGLU experts batched over the leading expert dim: (e, C, D) ->
    (e, C, D)."""
    g = torch.bmm(buf, _weight(p["w_gate"], cfg, dtype))
    u = torch.bmm(buf, _weight(p["w_up"], cfg, dtype))
    h = (F.silu(g.float()) * u.float()).to(dtype)
    return torch.bmm(h, _weight(p["w_down"], cfg, dtype))


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
    gate_vals, eflat, aux, ranks = _route(cfg, xt, p["router"])

    slot = eflat * cap + ranks
    valid = ranks < cap
    # dropped entries land in one extra row, thrown away
    safe_slot = torch.where(valid, slot, torch.full_like(slot, e * cap))
    buf = torch.zeros((e * cap + 1, d), dtype=x.dtype, device=x.device)
    buf[safe_slot] = xt.repeat_interleave(k, dim=0)
    y = _experts(cfg, p, buf[:-1].reshape(e, cap, d), x.dtype).reshape(e * cap, d)

    # combine: gather each kept entry's row back, weight by its gate
    gathered = y[torch.where(valid, slot, torch.zeros_like(slot))]  # (T * k, D)
    w = (gate_vals.reshape(-1) * valid.float()).to(x.dtype)
    out = (gathered * w[:, None]).reshape(t, k, d).sum(dim=1)
    return out.reshape(b, s, d), aux


# ------------------------------------------------------------------------------------
# expert parallelism (the reference's shard_map formulation, on local shards)
# ------------------------------------------------------------------------------------
def use_shard_map(shard) -> bool:
    """Expert parallel where the Sharder's mesh has a "model" axis of more
    than one rank; the einsum path otherwise."""
    mesh = getattr(shard, "mesh", None)
    return mesh is not None and mesh_sizes(mesh).get("model", 1) > 1


def moe_ep_local(cfg, p, x: torch.Tensor, lm) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE of this rank's x (B_loc, S, D), inside a block map
    (``lm`` a ``core.distributed.LocalMesh`` with a model axis).

    x: the rank's tokens (T_loc, D) (sharded over the token axes, replicated
    over "model"), entering the split block (their gradient summed over
    "model"), routed as every model rank routes them; the slot table of all
    E experts at the per-shard capacity ceil8(int(T_loc * k * cf / E) + 1),
    of which the rank keeps the rows of its e_loc = E / ep experts (``p``'s
    local expert shards; a gather: the dispatch moves nothing); its experts'
    SwiGLU; the gate-weighted combine of its experts' contributions at their
    source tokens, summed over "model" (the one collective of the forward);
    the aux loss averaged over the token axes. The router's gradient is each
    model rank's part (its experts' gates); the aux term, computed alike on
    every model rank, enters each at 1 / ep."""
    ep = lm.model_size
    b, s, d = x.shape
    t_loc = b * s
    e, k = cfg.n_experts, cfg.top_k
    if e % ep:
        raise ValueError(f"expert parallelism needs the {e} experts to divide the model "
                         f"axis' {ep} ranks")
    e_loc = e // ep
    cap = -(-(int(t_loc * k * cfg.capacity_factor / e) + 1) // 8) * 8
    xt = lm.enter(x.reshape(t_loc, d))
    gate_vals, eflat, aux, ranks = _route(cfg, xt, p["router"])
    aux = group_mean(aux, lm.tokens, grad_scale=1.0 / ep)
    slot = eflat * cap + ranks
    valid = ranks < cap
    n = t_loc * k
    # src[j]: the (token, choice) entry in slot j (n where the slot is empty)
    src = torch.full((e * cap + 1,), n, dtype=torch.long, device=xt.device)
    src[torch.where(valid, slot, torch.full_like(slot, e * cap))] = \
        torch.arange(n, device=xt.device)
    my = lm.model_rank
    src_my = src[my * e_loc * cap:(my + 1) * e_loc * cap]
    live = src_my < n
    entry = torch.clamp(src_my, max=n - 1)
    token_of = entry // k
    zero = torch.zeros((), dtype=xt.dtype, device=xt.device)
    rows = torch.where(live[:, None], xt[token_of], zero)
    y = _experts(cfg, p, rows.reshape(e_loc, cap, d), xt.dtype).reshape(e_loc * cap, d)
    gate = (gate_vals.reshape(-1) * valid.float()).to(xt.dtype)
    w_src = torch.where(live, gate[entry], zero)
    contrib = torch.zeros((t_loc + 1, d), dtype=xt.dtype, device=xt.device)
    contrib = contrib.index_add(0, torch.where(live, token_of, torch.full_like(token_of, t_loc)),
                                y * w_src[:, None])
    return lm.sum(contrib[:t_loc]).reshape(b, s, d), aux


def moe_replicated_local(cfg, p, x: torch.Tensor, lm) -> Tuple[torch.Tensor, torch.Tensor]:
    """The einsum path inside a block map without a model axis: the token
    shards gathered whole (the reference's global capacity), the block on
    the whole batch on every rank, this rank's rows of the output kept. Each
    rank's gradient then covers its own rows' outputs and, at 1 / the shard
    count, the aux loss every rank computes alike; the gather's backward
    sums them over the ranks."""
    rank, count = lm.token_rank_and_count()
    y, aux = apply_moe(cfg, p, lm.gather_tokens(x))
    b = x.shape[0]
    return y[rank * b:(rank + 1) * b], grad_scaled(aux, 1.0 / count)


def moe_local(cfg, p, x: torch.Tensor, lm=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The block's MoE on local tensors: ``apply_moe`` off a mesh (``lm``
    None), expert parallel on a model axis, else the replicated einsum
    path."""
    if lm is None:
        return apply_moe(cfg, p, x)
    if lm.model is not None:
        return moe_ep_local(cfg, p, x, lm)
    return moe_replicated_local(cfg, p, x, lm)


def moe_partial(p, prefix: str = "") -> set:
    """The leaves of DTensor MoE weights ``p`` whose gradient each model
    rank holds a part of: the router's, under expert parallelism."""
    from repro_torch.core.distributed import is_split

    return {prefix + "router"} if is_split(p["w_gate"], 0) else set()


def apply_moe_ep(cfg, p, x: torch.Tensor, shard: Sharder) -> Tuple[torch.Tensor, torch.Tensor]:
    """The expert-parallel block alone in one block map on ``shard``'s mesh
    (x and p DTensors; ``moe_ep_local`` on each rank's shards). The experts
    come in whole over the batch axes and sharded by expert over "model"."""
    from repro_torch.core.distributed import block_map

    return block_map(lambda lm, x_, p_: moe_ep_local(cfg, p_, x_, lm), shard.mesh, x, p,
                     partial=moe_partial(p), aux=True)
