"""train_step factory: forward and backward (with microbatch gradient
accumulation) and the AdamW update; the port of ``repro.train.step``.

  * microbatches: the batch in k slices, their gradients summed in
    ``accum_dtype`` and divided by k in f32, the loss averaged;
  * per-layer remat (``TrainProfile.remat``), with the reference's policy
    names: None / "nothing" keep nothing, "dots" keeps the matmul outputs
    (``Model.forward``);
  * the gradient of every parameter leaf through ``torch.autograd.grad``;
    attention's backward is flash_attention_bwd's kernel on the card, the
    plain ``flash_bwd_torch`` on the CPU (``kernels.ops.attention``);
  * on a mesh (``mesh`` a ``DeviceMesh`` with dim names, ``rules`` the
    ``launch.sharding`` table): parameters, gradients and AdamW moments are
    DTensors laid out by the rules (``core.distributed.tree_distribute``,
    ``optim.adamw_init``), the batch is placed over the batch axes, each
    block runs on local shards in one ``local_map`` with explicit
    collectives (``core.distributed.block_map``), the embedding and the
    loss in one each, and the update runs on each rank's shards (the clip's
    norm is the whole gradient's). Every family trains on a mesh, with f32
    or int8 moments; ``check_mesh`` refuses only an int8 moment whose quant
    block a shard would split.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.distributed import distribute, is_dtensor, q_bindings
from repro_torch.core.tree import tree_leaves, tree_leaves_with_path, tree_map
from repro_torch.models.bridge import reference_shapes
from repro_torch.models.layers import NULL_SHARDER, Sharder
from repro_torch.optim import AdamWConfig, adamw_init_specs, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainProfile:
    num_microbatches: int = 1
    accum_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: Optional[str] = None  # None | "dots" | "nothing"
    aux_weight: float = 0.01


def on_mesh(shard: Sharder):
    """The context the sharded step runs in: plain tensors mixed with
    DTensors (RoPE tables, masks, scalars) read as replicated."""
    if shard.mesh is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()


def loss_and_grads(model, params, batch, profile: TrainProfile = TrainProfile(),
                   attn_impl: str = "auto", shard: Sharder = NULL_SHARDER):
    """(loss, gradient tree) of ``model.loss_fn`` at ``params`` on one
    batch: each leaf's gradient in its dtype (zeros for a leaf the loss does
    not reach), the loss detached. On a mesh (``shard``; params and batch
    DTensors) each gradient takes its parameter's placements."""
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_() for t in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    with on_mesh(shard):
        loss, _ = model.loss_fn(tracked, batch, remat=profile.remat,
                                remat_policy=profile.remat_policy,
                                aux_weight=profile.aux_weight, attn_impl=attn_impl, shard=shard)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(_placed_like(g, t) if g is not None else torch.zeros_like(t)
              for g, t in zip(grads, live))
    return loss.detach(), tree_map(lambda _: next(it), params)


def _placed_like(g, t):
    if is_dtensor(g) and tuple(g.placements) != tuple(t.placements):
        return g.redistribute(t.device_mesh, t.placements)
    return g


def check_mesh(state_specs, mesh, rules) -> None:
    """The refusal of the sharded step: an int8 moment whose quant block a
    shard would split (the local last dim of its q buffer no multiple of
    the block), named by its leaf; each rank encodes its own blocks."""
    from repro_torch.core.distributed import mesh_sizes, spec_axes

    sizes = mesh_sizes(mesh)
    for path, s in tree_leaves_with_path(state_specs["m"], is_leaf=lambda x: hasattr(x, "quant")):
        if not s.is_quantized():
            continue
        last = q_bindings(s, mesh, rules)["q"][-1]
        n = 1
        for a in (() if last is None else (last,) if isinstance(last, str) else last):
            n *= sizes[a]
        if (s.shape[-1] // n) % s.quant.block:
            name = "/".join(map(str, path))
            raise NotImplementedError(
                f"int8 AdamW moment of {name} {tuple(s.shape)} (axes {spec_axes(s)}): its last "
                f"dim is split {n} ways to {s.shape[-1] // n}, no multiple of the quant block "
                f"{s.quant.block}; a shard would split a block")


def place_batch(batch, mesh, rules):
    """A batch every rank holds whole, as DTensors sharded over the batch
    axes (each rank keeps its rows; nothing is sent)."""
    return {k: x if is_dtensor(x) else distribute(
        x, mesh, rules.placements(("batch",) + (None,) * (x.dim() - 1), x.shape, mesh))
        for k, x in batch.items()}


def _full(x):
    return x.full_tensor() if is_dtensor(x) else x


def make_train_step(model, opt: AdamWConfig, profile: TrainProfile = TrainProfile(),
                    mesh=None, rules=None, attn_impl: str = "auto"):
    """-> (train_step, param_specs, state_specs), with
    ``train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"})``: ``batch`` a dict of tensors on the model's device
    ({"tokens": (B, T + 1) int}, plus "frames" / "image_embeds" for encdec /
    vlm, optionally "mask"). ``attn_impl`` is ``Model.loss_fn``'s ("torch"
    forces the plain versions). The metrics stay tensors on the device.

    With ``mesh`` and ``rules`` the step is sharded: params and opt_state
    are the DTensor trees ``tree_distribute`` / ``adamw_init(mesh=)`` give,
    ``batch`` is the whole batch on every rank (placed over the batch axes
    here; microbatches are cut from it first), and the metrics are plain
    tensors, the same on every rank. Without a mesh it is the one-device
    step."""
    param_specs = model.param_specs()
    state_specs = adamw_init_specs(param_specs, opt, reference_shapes(param_specs, model.cfg))
    shard = Sharder(mesh, rules) if mesh is not None else NULL_SHARDER
    if mesh is not None:
        check_mesh(state_specs, mesh, rules)

    def grads_of(params, batch):
        if mesh is not None:
            batch = place_batch(batch, mesh, rules)
        return loss_and_grads(model, params, batch, profile, attn_impl, shard)

    def compute_grads(params, batch):
        k = profile.num_microbatches
        if k <= 1:
            return grads_of(params, batch)
        g_sum, l_sum = None, torch.zeros((), dtype=torch.float32)
        for i in range(k):
            mb = {name: x.reshape(k, x.shape[0] // k, *x.shape[1:])[i]
                  for name, x in batch.items()}
            loss, g = grads_of(params, mb)
            g = tree_map(lambda t: t.to(profile.accum_dtype), g)
            g_sum = g if g_sum is None else tree_map(torch.add, g_sum, g)
            l_sum = l_sum.to(loss.device) + _full(loss)
        return l_sum / k, tree_map(lambda t: t.float() / k, g_sum)

    def train_step(params, opt_state, batch):
        loss, grads = compute_grads(params, batch)
        with on_mesh(shard):
            params, opt_state, om = adamw_update(params, grads, opt_state, state_specs, opt)
        metrics = {"loss": loss, **om}
        if mesh is not None:
            metrics = {k: _full(v) for k, v in metrics.items()}
        return params, opt_state, metrics

    return train_step, param_specs, state_specs
