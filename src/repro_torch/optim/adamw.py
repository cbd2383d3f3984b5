"""AdamW with optional int8 moments (the port of ``repro.optim.adamw``).

The 8-bit optimizer is the paper's accessor concept applied to training
state: m and v are stored through ``QuantizedAccessor(float32, bits=8,
block)`` ({"q", "scale"} buffers from ``core.distributed.quantize_array``),
dequantized at the compute boundary and re-encoded with fresh per-block
scales each step; v lives in the log domain (``_V_FLOOR``, ``_V_SHIFT``). All
update math is f32, with bias correction from the int32 step.

Where the reference's rules read a parameter's shape, they read the shape of
the reference's leaf: the reference stacks every block-program entry's
per-layer leaves on a leading dim (a vision group's self layers on two),
where the port keeps one tensor a layer. So weight decay (``ndim >= 2``)
reaches every block's norm scales and biases, as in the reference, and the
int8 rule (last dim a multiple of ``state_block``) is the reference's. Each
moment's ``MomentSpec`` carries that reference shape
(``models.bridge.reference_shapes`` gives it for a model's tree).

Each moment carries its parameter's logical axes, so on a mesh it is laid
out like its parameter (``adamw_init(mesh=, rules=)``; an int8 moment's
{"q", "scale"} as ``core.distributed.q_bindings`` lays a quantized leaf
out), and the update runs on each rank's local shards: it is elementwise,
and an int8 moment's blocks lie whole in a shard (``train.step.check_mesh``
refuses a leaf where they would not). The clip's norm
(``clip_by_global_norm``) is the whole gradient's: each rank's sums of
squares over its shards, each over the ranks that replicate it, added over
the mesh in one all-reduce a mesh dim.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.core.accessors import QuantizedAccessor
from repro_torch.core.distributed import (
    dequantize_array,
    is_dtensor,
    local_shape_and_offset,
    local_tensor,
    placed_like,
    quantize_array,
    spec_axes,
    tree_shardings,
)
from repro_torch.core.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: Union[float, Callable[[torch.Tensor], torch.Tensor]] = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    int8_state: bool = False
    state_block: int = 64

    def lr_at(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=torch.float32, device=step.device)


@dataclasses.dataclass(frozen=True)
class MomentSpec:
    """One moment leaf: the parameter's shape in the port, its shape in the
    reference's stacked tree (the decay and int8 rules read it), the int8
    accessor when the moment is quantized, and the parameter's logical axes
    (its layout on a mesh)."""

    shape: Tuple[int, ...]
    ref_shape: Tuple[int, ...]
    quant: Optional[QuantizedAccessor] = None
    logical_axes: Optional[Tuple[Optional[str], ...]] = None

    def is_quantized(self) -> bool:
        return self.quant is not None

    @property
    def decay(self) -> bool:
        """The reference decays ``ndim >= 2`` leaves: not norms, biases,
        scalars, unless the layer stacking gives them a second dim."""
        return len(self.ref_shape) >= 2


def _is_spec(x) -> bool:
    return hasattr(x, "shape") and hasattr(x, "dtype") and not isinstance(x, torch.Tensor)


def moment_spec(pspec, ref_shape, opt: AdamWConfig) -> MomentSpec:
    """Quantized when int8 state is on, the reference's trailing dim divides
    into blocks and the parameter is not itself quantized (tiny tensors stay
    f32)."""
    ref_shape = tuple(ref_shape)
    if (opt.int8_state and pspec.shape and ref_shape[-1] % opt.state_block == 0
            and getattr(pspec, "quant", None) is None):
        acc = QuantizedAccessor(torch.float32, bits=8, block=opt.state_block)
        return MomentSpec(tuple(pspec.shape), ref_shape, acc, spec_axes(pspec))
    return MomentSpec(tuple(pspec.shape), ref_shape, logical_axes=spec_axes(pspec))


def adamw_init_specs(param_specs, opt: AdamWConfig, ref_shapes=None):
    """Optimizer-state spec tree {"m", "v": MomentSpec trees, "step"}.
    ``ref_shapes``: the reference's shape of each leaf (a tree of tuples like
    ``param_specs``); by default each spec's own shape."""
    if ref_shapes is None:
        ref_shapes = tree_map(lambda s: tuple(s.shape), param_specs, is_leaf=_is_spec)
    m = tree_map(lambda s, r: moment_spec(s, r, opt), param_specs, ref_shapes,
                 is_leaf=_is_spec)
    return {"m": m, "v": m, "step": MomentSpec((), ())}


def adamw_init(state_specs, device=None, mesh=None, rules=None):
    """Zeroed optimizer state for ``state_specs`` on ``device``: f32 zeros, or
    the int8 encoding of zeros ({"q": 0, "scale": 1}, as the reference's
    ``tree_initialize``), and the int32 step 0. With ``mesh`` and ``rules``
    each moment is laid out like its parameter (an int8 one as its {"q",
    "scale"} DTensors), each rank allocating and encoding only its block
    (the step stays a plain tensor on every rank)."""
    def zeros(s: MomentSpec):
        if mesh is not None:
            return _zeros_on_mesh(s, device, mesh, rules)
        z = torch.zeros(s.shape, dtype=torch.float32, device=device)
        return quantize_array(z, s.quant) if s.is_quantized() else z

    return {"m": tree_map(zeros, state_specs["m"]), "v": tree_map(zeros, state_specs["v"]),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


def _zeros_on_mesh(s: MomentSpec, device, mesh, rules):
    from torch.distributed.tensor import DTensor

    placements = tree_shardings(s, mesh, rules)
    pl = placements["q"] if s.is_quantized() else placements
    local, _ = local_shape_and_offset(s.shape, pl, mesh)
    z = torch.zeros(local, dtype=torch.float32, device=device)
    if not s.is_quantized():
        return DTensor.from_local(z, mesh, placements, run_check=False)
    return {k: DTensor.from_local(v, mesh, placements[k], run_check=False)
            for k, v in quantize_array(z, s.quant).items()}


def _local(t):
    """A DTensor's local shard, a tree of them leaf by leaf; a plain tensor as
    it is."""
    return tree_map(lambda x: local_tensor(x) if is_dtensor(x) else x, t)


def _placed(t, like):
    """Local shard(s) ``t`` back as DTensors laid out as ``like`` (leaf by
    leaf for an int8 moment's {"q", "scale"})."""
    return tree_map(lambda x, ref: placed_like(x, ref) if is_dtensor(ref) else x, t, like)


_V_FLOOR = 1e-12
_V_SHIFT = 27.631021  # -log(_V_FLOOR): a zero-initialized buffer decodes to v == 0


def _decode_moment(buf, spec: MomentSpec, *, log_domain: bool = False) -> torch.Tensor:
    if isinstance(buf, dict):  # quantized
        val = dequantize_array(buf, spec.quant)
        if log_domain:
            return torch.clamp(torch.exp(val - _V_SHIFT) - _V_FLOOR, min=0.0)
        return val
    return buf


def _encode_moment(val: torch.Tensor, spec: MomentSpec, *, log_domain: bool = False):
    """int8 moments: m is zero-mean, so linear symmetric blocks suit it; v
    spans orders of magnitude within a block (linear blocks zero its small
    entries and the Adam denominator collapses), so it is stored as log(v +
    _V_FLOOR) + _V_SHIFT, a bounded relative error that never decodes to 0."""
    if spec.is_quantized():
        if log_domain:
            val = torch.log(val + _V_FLOOR) + _V_SHIFT
        return quantize_array(val, spec.quant)
    return val


def _sum_of_squares(grads) -> torch.Tensor:
    """The f32 sum of squares of every gradient element. On DTensor grads
    each rank sums its shards, each leaf's divided by the ranks that
    replicate it, and the sums are added over every mesh dim."""
    leaves = tree_leaves(grads)
    if not any(is_dtensor(g) for g in leaves):
        return sum(torch.sum(torch.square(g.float())) for g in leaves)
    import torch.distributed as dist

    mesh = next(g for g in leaves if is_dtensor(g)).device_mesh
    total = 0.0
    for g in leaves:
        rep = 1
        for i, p in enumerate(g.placements):
            if p.is_replicate():
                rep *= mesh.size(i)
            elif not p.is_shard():
                raise ValueError(f"a gradient placed {g.placements}: a pending sum")
        total = total + torch.sum(torch.square(local_tensor(g).float())) / rep
    for i in range(mesh.ndim):
        if mesh.size(i) > 1:
            dist.all_reduce(total, group=mesh.get_group(i))
    return total


def clip_by_global_norm(grads, max_norm: float):
    """Grads scaled by min(1, max_norm / ||g||) (f32, cast back to each
    grad's dtype) and the f32 global norm. On DTensor grads the norm is the
    whole gradient's (``_sum_of_squares``), a plain tensor alike on every
    rank, and each rank scales its own shards."""
    gn = torch.sqrt(_sum_of_squares(grads))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: _placed((_local(g).float() * scale).to(g.dtype), g), grads), gn


def _is_moment(x) -> bool:
    return isinstance(x, dict) and "q" in x


def adamw_update(params, grads, state, state_specs, opt: AdamWConfig):
    """One AdamW step -> (new params, new state, {"grad_norm", "lr"}).

    ``params`` may be bf16 (the master copy, as in the reference); the update
    is f32 throughout and each new parameter is cast to its old dtype. The
    step, lr and bias corrections stay tensors on the parameters' device, so
    a step never waits on the host. The reference also takes the parameter
    specs; here the moment specs (``state_specs``) carry all that the decay
    and int8 rules read."""
    step = state["step"] + 1
    if opt.grad_clip:
        grads, gnorm = clip_by_global_norm(grads, opt.grad_clip)
    else:
        gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
    lr = opt.lr_at(step)
    b1, b2 = opt.b1, opt.b2
    sf = step.float()
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32, device=step.device), sf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32, device=step.device), sf)

    def one(mspec, p, g, m, v):
        if is_dtensor(p):  # elementwise: on the local shards
            if tuple(g.placements) != tuple(p.placements):
                raise ValueError(f"a gradient placed {g.placements} for a parameter placed "
                                 f"{p.placements}")
            new = one(mspec, *map(_local, (p, g, m, v)))
            return _placed(new[0], p), _placed(new[1], m), _placed(new[2], v)
        gf = g.float()
        mf = _decode_moment(m, mspec)
        vf = _decode_moment(v, mspec, log_domain=True)
        mf = b1 * mf + (1 - b1) * gf
        vf = b2 * vf + (1 - b2) * gf * gf
        update = (mf / bc1) / (torch.sqrt(vf / bc2) + opt.eps)
        pf = p.float()
        if opt.weight_decay and mspec.decay:  # no decay on norms / biases / scalars
            update = update + opt.weight_decay * pf
        pf = pf - lr * update
        return (pf.to(p.dtype), _encode_moment(mf, mspec),
                _encode_moment(vf, mspec, log_domain=True))

    out = tree_map(one, state_specs["m"], params, grads, state["m"], state["v"])
    is_triple = lambda x: isinstance(x, tuple)  # noqa: E731
    new_p = tree_map(lambda t: t[0], out, is_leaf=is_triple)
    new_m = tree_map(lambda t: t[1], out, is_leaf=is_triple)
    new_v = tree_map(lambda t: t[2], out, is_leaf=is_triple)
    return new_p, {"m": new_m, "v": new_v, "step": step}, {"grad_norm": gnorm, "lr": lr}
