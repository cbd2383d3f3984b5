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
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple, Union

import torch

from repro_torch.core.accessors import QuantizedAccessor
from repro_torch.core.distributed import dequantize_array, quantize_array
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
    reference's stacked tree (the decay and int8 rules read it), and the
    int8 accessor when the moment is quantized."""

    shape: Tuple[int, ...]
    ref_shape: Tuple[int, ...]
    quant: Optional[QuantizedAccessor] = None

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
        return MomentSpec(tuple(pspec.shape), ref_shape, acc)
    return MomentSpec(tuple(pspec.shape), ref_shape)


def adamw_init_specs(param_specs, opt: AdamWConfig, ref_shapes=None):
    """Optimizer-state spec tree {"m", "v": MomentSpec trees, "step"}.
    ``ref_shapes``: the reference's shape of each leaf (a tree of tuples like
    ``param_specs``); by default each spec's own shape."""
    if ref_shapes is None:
        ref_shapes = tree_map(lambda s: tuple(s.shape), param_specs, is_leaf=_is_spec)
    m = tree_map(lambda s, r: moment_spec(s, r, opt), param_specs, ref_shapes,
                 is_leaf=_is_spec)
    return {"m": m, "v": m, "step": MomentSpec((), ())}


def adamw_init(state_specs, device=None):
    """Zeroed optimizer state for ``state_specs`` on ``device``: f32 zeros, or
    the int8 encoding of zeros ({"q": 0, "scale": 1}, as the reference's
    ``tree_initialize``), and the int32 step 0."""
    def zeros(s: MomentSpec):
        z = torch.zeros(s.shape, dtype=torch.float32, device=device)
        return quantize_array(z, s.quant) if s.is_quantized() else z

    return {"m": tree_map(zeros, state_specs["m"]), "v": tree_map(zeros, state_specs["v"]),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


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


def clip_by_global_norm(grads, max_norm: float):
    """Grads scaled by min(1, max_norm / ||g||) (f32, cast back to each
    grad's dtype) and the f32 global norm."""
    gn = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))
    scale = torch.clamp(max_norm / torch.clamp(gn, min=1e-12), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), gn


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
