"""MatVec — y = A @ x, layout-parameterized (paper Fig. 6).

Port of ``repro.kernels.matvec``:

  matvec_torch  <- repro.kernels.ref.matvec (the plain version)
  matvec_right  <- matvec_right — launches csrc/paper_suite.cu::
                   matvec_kernel<T, Right>
  matvec_left   <- matvec_left — launches matvec_kernel<T, Left>

The paper's experiment: the SAME algorithm with layout_right vs layout_left
A is 3-7x apart on a CPU and about 10x, inverted, on a GPU. Both kernels are
one body templated on a layout policy, one thread per output row: with
layout_left neighbouring threads read neighbouring addresses (coalesced),
with layout_right each thread walks its own row. ``ops.matvec`` picks the
instantiation from the MdSpan's layout type — "change the layout in the
type, not the algorithm".

Sums in f32, output in x's dtype (A and x share the dtype on CUDA). On CPU
tensors a wrapper returns the plain version; on CUDA tensors it launches its
kernel or raises.
"""
from __future__ import annotations

import torch

from ._paper_suite import check_operands, launch


def matvec_torch(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for logical A (I, J), in f32, cast to x's dtype."""
    return (a.float() @ x.float()).to(x.dtype)


def _launch(buf: torch.Tensor, x: torch.Tensor, rows: int, layout: int, what: str):
    code = check_operands(what, buf, x)
    cols = x.shape[0]
    y = torch.empty(rows, dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    launch("repro_matvec", what, code, layout, buf.data_ptr(), x.data_ptr(), y.data_ptr(),
           rows, cols, device=x.device)
    return y


def _check_shapes(what, buf, x, inner: int) -> None:
    if buf.dim() != 2 or x.dim() != 1 or x.shape[0] != inner:
        raise ValueError(f"{what}: shapes disagree: A buffer {tuple(buf.shape)}, "
                         f"x {tuple(x.shape)}")


def matvec_right(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A stored row-major: ``a`` is the physical (I, J) buffer."""
    _check_shapes("matvec_right", a, x, a.shape[1] if a.dim() == 2 else -1)
    if a.device.type == "cpu":
        return matvec_torch(a, x)
    y = _launch(a, x, a.shape[0], 0, "matvec_right")
    matvec_right.launches += 1
    return y


def matvec_left(at: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A stored column-major: ``at`` is the physical (J, I) buffer."""
    _check_shapes("matvec_left", at, x, at.shape[0] if at.dim() == 2 else -1)
    if at.device.type == "cpu":
        return matvec_torch(at.t(), x)
    y = _launch(at, x, at.shape[1], 1, "matvec_left")
    matvec_left.launches += 1
    return y


matvec_right.launches = 0
matvec_left.launches = 0

KERNEL_WRAPPERS = {"matvec_right": matvec_right, "matvec_left": matvec_left}
