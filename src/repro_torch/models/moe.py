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

On a mesh with a "model" axis of more than one rank the block runs expert
parallel (``apply_moe_ep``, the reference's ``shard_map`` formulation, here
inside ``local_map``): tokens sharded over the batch axes and replicated
over "model", every model rank routes alike and keeps the entries of its own
``E / ep`` experts (a per-shard capacity), and one sum over "model" of the
gate-weighted combine merges them. ``apply_moe_dispatch`` picks the path.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.accessors import QuantizedAccessor
from repro_torch.core.distributed import dequantize_array, group_mean, group_sum, mesh_sizes
from repro_torch.kernels import ops

from .layers import NULL_SHARDER, ParamSpec, Sharder, fit_quant


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
# expert parallelism (the reference's shard_map formulation, in local_map)
# ------------------------------------------------------------------------------------
def use_shard_map(shard) -> bool:
    """Expert parallel where the Sharder's mesh has a "model" axis of more
    than one rank; the einsum path otherwise."""
    mesh = getattr(shard, "mesh", None)
    return mesh is not None and mesh_sizes(mesh).get("model", 1) > 1


def _mesh_dim(mesh, name: str) -> int:
    return list(mesh.mesh_dim_names).index(name)


def apply_moe_ep(cfg, p, x: torch.Tensor, shard: Sharder) -> Tuple[torch.Tensor, torch.Tensor]:
    """Expert-parallel MoE of x (B, S, D), a DTensor, on ``shard``'s mesh.

    Inside ``local_map``, on each rank: its tokens (T_loc, D) (sharded over
    the batch axes, replicated over "model"), routed as every model rank
    routes them; the slot table of all E experts at the per-shard capacity
    ceil8(int(T_loc * k * cf / E) + 1), of which the rank keeps the rows of
    its e_loc = E / ep experts (a gather: the dispatch moves nothing); its
    experts' SwiGLU; the gate-weighted combine of its experts'
    contributions at their source tokens, summed over "model" (the one
    collective of the forward); the aux loss averaged over the token axes.
    The experts come in whole over the batch axes and sharded by expert over
    "model". Gradients: a token's, the router's and (over the token axes)
    an expert's sum over the ranks (Partial); the aux term, computed alike
    on every model rank, enters each at 1 / ep."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = shard.mesh
    sizes = mesh_sizes(mesh)
    ep = sizes["model"]
    tok_axes = tuple(a for a in ("pod", "data") if a in sizes)
    n_tok = 1
    for a in tok_axes:
        n_tok *= sizes[a]
    b, s, d = x.shape
    t = b * s
    e, k = cfg.n_experts, cfg.top_k
    if t % n_tok or e % ep:
        raise ValueError(f"expert parallelism needs the {t} tokens to divide the token axes' "
                         f"{n_tok} ranks and the {e} experts the model axis' {ep}")
    t_loc, e_loc = t // n_tok, e // ep
    cap = -(-(int(t_loc * k * cfg.capacity_factor / e) + 1) // 8) * 8
    model_dim = _mesh_dim(mesh, "model")
    tok_dims = [_mesh_dim(mesh, a) for a in tok_axes]
    tok_groups = [mesh.get_group(i) for i in tok_dims]
    model_group = mesh.get_group(model_dim)
    ndim = len(mesh.mesh_dim_names)

    def pl(on_tokens, on_model):
        return [on_tokens if i in tok_dims else on_model if i == model_dim else Replicate()
                for i in range(ndim)]

    x_pl, x_grad = pl(Shard(0), Replicate()), pl(Shard(0), Partial())
    r_pl, r_grad = pl(Replicate(), Replicate()), pl(Partial(), Partial())
    w_pl, w_grad = pl(Replicate(), Shard(0)), pl(Partial(), Shard(0))
    names = ("w_gate", "w_up", "w_down")
    quantized = isinstance(p["w_gate"], dict)

    def local(xt, router, *ws):
        my = mesh.get_local_rank("model")
        gate_vals, eflat, aux, ranks = _route(cfg, xt, router)
        aux = group_mean(aux, tok_groups, grad_scale=1.0 / ep)
        slot = eflat * cap + ranks
        valid = ranks < cap
        n = t_loc * k
        # src[j]: the (token, choice) entry in slot j (n where the slot is empty)
        src = torch.full((e * cap + 1,), n, dtype=torch.long, device=xt.device)
        src[torch.where(valid, slot, torch.full_like(slot, e * cap))] = \
            torch.arange(n, device=xt.device)
        src_my = src[my * e_loc * cap:(my + 1) * e_loc * cap]
        live = src_my < n
        entry = torch.clamp(src_my, max=n - 1)
        token_of = entry // k
        rows = torch.where(live[:, None], xt[token_of], torch.zeros((), dtype=xt.dtype,
                                                                      device=xt.device))
        if quantized:
            w = {nm: {"q": ws[2 * i], "scale": ws[2 * i + 1]} for i, nm in enumerate(names)}
        else:
            w = dict(zip(names, ws))
        y = _experts(cfg, w, rows.reshape(e_loc, cap, d), xt.dtype).reshape(e_loc * cap, d)
        gate = (gate_vals.reshape(-1) * valid.float()).to(xt.dtype)
        w_src = torch.where(live, gate[entry], torch.zeros((), dtype=xt.dtype,
                                                           device=xt.device))
        contrib = torch.zeros((t_loc + 1, d), dtype=xt.dtype, device=xt.device)
        contrib = contrib.index_add(0, torch.where(live, token_of, torch.full_like(token_of,
                                                                                  t_loc)),
                                    y * w_src[:, None])
        return group_sum(contrib[:t_loc], [model_group]), aux

    if quantized:
        wts = [p[nm][part] for nm in names for part in ("q", "scale")]
    else:
        wts = [p[nm] for nm in names]
    xt = x.reshape(t, d)
    out, aux = local_map(
        local, out_placements=(x_pl, r_pl),
        in_placements=(x_pl, r_pl, *([w_pl] * len(wts))),
        in_grad_placements=(x_grad, r_grad, *([w_grad] * len(wts))),
        device_mesh=mesh, redistribute_inputs=True)(xt, p["router"], *wts)
    return out.reshape(b, s, d), aux


def _apply_moe_replicated(cfg, p, x: torch.Tensor, shard: Sharder):
    """The einsum path on a mesh without a model axis: every rank computes
    the whole block on the whole batch (the reference's global capacity),
    inside ``local_map`` on replicated inputs."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.tree import tree_leaves, tree_map

    mesh = shard.mesh
    rep = [Replicate()] * len(mesh.mesh_dim_names)
    leaves = tree_leaves(p)

    def local(x_, *ws):
        it = iter(ws)
        return apply_moe(cfg, tree_map(lambda _: next(it), p), x_)

    return local_map(local, out_placements=(rep, rep), in_placements=(rep,) * (1 + len(leaves)),
                     device_mesh=mesh, redistribute_inputs=True)(x, *leaves)


def apply_moe_dispatch(cfg, p, x: torch.Tensor, shard: Sharder = NULL_SHARDER):
    """The block's entry: expert parallel where ``use_shard_map`` says so,
    else the einsum path (on a mesh, whole on every rank)."""
    if shard.active(x):
        if use_shard_map(shard):
            return apply_moe_ep(cfg, p, x, shard)
        return _apply_moe_replicated(cfg, p, x, shard)
    return apply_moe(cfg, p, x)
