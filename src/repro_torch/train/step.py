"""train_step factory: forward and backward (with microbatch gradient
accumulation) and the AdamW update; the port of ``repro.train.step``.

  * microbatches: the batch in k slices, their gradients summed in
    ``accum_dtype`` and divided by k in f32, the loss averaged;
  * per-layer remat (``TrainProfile.remat``), with the reference's policy
    names: None / "nothing" keep nothing, "dots" keeps the matmul outputs
    (``Model.forward``);
  * the gradient of every parameter leaf through ``torch.autograd.grad``;
    attention's backward is flash_attention_bwd's kernel on the card, the
    plain ``flash_bwd_torch`` on the CPU (``kernels.ops.attention``).

Sharding (the reference's ``mesh`` / ``rules``) waits for ROADMAP item 6.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.models.bridge import reference_shapes
from repro_torch.optim import AdamWConfig, adamw_init_specs, adamw_update


@dataclasses.dataclass(frozen=True)
class TrainProfile:
    num_microbatches: int = 1
    accum_dtype: Any = torch.float32
    remat: bool = True
    remat_policy: Optional[str] = None  # None | "dots" | "nothing"
    aux_weight: float = 0.01


def loss_and_grads(model, params, batch, profile: TrainProfile = TrainProfile(),
                   attn_impl: str = "auto"):
    """(loss, gradient tree) of ``model.loss_fn`` at ``params`` on one
    batch: each leaf's gradient in its dtype (zeros for a leaf the loss does
    not reach), the loss detached."""
    leaves = tree_leaves(params)
    live = [t.detach().requires_grad_() for t in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    loss, _ = model.loss_fn(tracked, batch, remat=profile.remat,
                            remat_policy=profile.remat_policy, aux_weight=profile.aux_weight,
                            attn_impl=attn_impl)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t) for g, t in zip(grads, live))
    return loss.detach(), tree_map(lambda _: next(it), params)


def make_train_step(model, opt: AdamWConfig, profile: TrainProfile = TrainProfile(),
                    attn_impl: str = "auto"):
    """-> (train_step, param_specs, state_specs), with
    ``train_step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "grad_norm", "lr"})``: ``batch`` a dict of tensors on the model's device
    ({"tokens": (B, T + 1) int}, plus "frames" / "image_embeds" for encdec /
    vlm, optionally "mask"). ``attn_impl`` is ``Model.loss_fn``'s ("torch"
    forces the plain versions). The metrics stay tensors on the device."""
    param_specs = model.param_specs()
    state_specs = adamw_init_specs(param_specs, opt, reference_shapes(param_specs, model.cfg))

    def grads_of(params, batch):
        return loss_and_grads(model, params, batch, profile, attn_impl)

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
            l_sum = l_sum.to(loss.device) + loss
        return l_sum / k, tree_map(lambda t: t.float() / k, g_sum)

    def train_step(params, opt_state, batch):
        loss, grads = compute_grads(params, batch)
        params, opt_state, om = adamw_update(params, grads, opt_state, state_specs, opt)
        return params, opt_state, {"loss": loss, **om}

    return train_step, param_specs, state_specs
