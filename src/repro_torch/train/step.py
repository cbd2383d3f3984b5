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
    ``optim.adamw_init``), the batch is placed over the batch axes, the
    activations by the model's ``Sharder``, attention, the loss and the MoE
    run on each rank's shard inside ``local_map``, and the update runs on
    the DTensors (the clip's norm is the whole gradient's). The dense and
    MoE families train on a mesh; the SSM, hybrid, encoder-decoder and
    vision families and int8 moments are refused there (``check_mesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.distributed import distribute, is_dtensor
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.bridge import reference_shapes
from repro_torch.models.layers import NULL_SHARDER, Sharder
from repro_torch.optim import AdamWConfig, adamw_init_specs, adamw_update

SHARDED_FAMILIES = ("dense", "moe")


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


def check_mesh(cfg, opt: AdamWConfig) -> None:
    """The refusals of the sharded step: the families whose kernels have no
    ``local_map`` wrappers yet, and int8 moments (ROADMAP Queue 1 item 6)."""
    if cfg.family not in SHARDED_FAMILIES:
        raise NotImplementedError(
            f"a sharded train step of the {cfg.family} family waits for ROADMAP Queue 1 item "
            "6: its scan and attention kernels need local_map wrappers of their own")
    if opt.int8_state:
        raise NotImplementedError("int8 AdamW moments on a mesh wait for ROADMAP Queue 1 item 6")


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
        check_mesh(model.cfg, opt)

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
