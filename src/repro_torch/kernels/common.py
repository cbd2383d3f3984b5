"""The port's device policy (``core.device.resolve_device``, re-exported) and
the shape helpers of the reference's ``kernels/common.py`` (its TPU tiling
constants and interpret-mode switch have no counterpart: the port's kernels
run on the card or not at all)."""
from __future__ import annotations

import torch

from repro_torch.core.device import resolve_device  # noqa: F401  (re-exported)


# -- shape helpers (the reference's kernels/common.py) -------------------------------
def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def pick_block(extent: int, target: int, align: int = 1) -> int:
    """Largest block <= target that is a multiple of ``align`` (or the whole extent
    if it is smaller)."""
    if extent <= target:
        return extent
    b = (target // align) * align
    return max(b, align)


def pad_to(x: torch.Tensor, shape) -> torch.Tensor:
    """``x`` zero-padded at the end of each dim up to ``shape`` (``x`` itself
    when it already has that shape)."""
    pads = [s - xs for xs, s in zip(x.shape, shape)]
    if not any(pads):
        return x
    flat = []
    for p in reversed(pads):  # F.pad lists the last dim first
        flat += [0, p]
    return torch.nn.functional.pad(x, flat)


# -- what a kernel wrapper refuses ----------------------------------------------------
def no_dtensor(name: str, *tensors) -> None:
    """Raise TypeError where a DTensor reaches the ctypes wrapper of the
    kernel ``name``: a DTensor is ``is_cuda``, but its data pointer is not
    the block the kernel would have to read. Sharded callers run the kernel
    on each rank's local tensors inside ``local_map``."""
    from repro_torch.core.distributed import is_dtensor

    for t in tensors:
        if is_dtensor(t):
            raise TypeError(f"{name}: a DTensor reached the kernel's wrapper; call it on each "
                            "rank's local tensors inside torch.distributed.tensor.experimental"
                            ".local_map")


def no_grad_through(name: str, *tensors) -> None:
    """Raise where autograd would need a backward that the kernel ``name``
    does not have: grad mode on and an input that requires grad. A kernel's
    output is filled outside autograd (it has no grad_fn), so without this
    the gradient of everything before it would be lost without a word.
    A DTensor among ``tensors`` is refused first (``no_dtensor``)."""
    no_dtensor(name, *tensors)
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in tensors):
        raise RuntimeError(
            f"{name} has no backward on CUDA: call it under torch.no_grad() or on "
            "tensors that do not require grad"
        )
