"""MatVec — y = A @ x, layout-parameterized (paper Fig. 6).

Port of ``repro.kernels.matvec``:

  matvec_torch      <- repro.kernels.ref.matvec (the plain version)
  plan_matvec_left  the left kernel's split of j across blocks (plain; no
                    reference namesake)
  matvec_right      <- matvec_right — launches csrc/paper_suite.cu::
                       matvec_kernel<T, Right, VEC>
  matvec_left       <- matvec_left — launches matvec_kernel<T, Left, VEC>
                       (then matvec_splits_kernel where j is split)

The paper's experiment: the SAME algorithm with layout_right vs layout_left
A is 3-7x apart on a CPU and about 10x, inverted, on a GPU. Both kernels are
one body templated on a layout policy whose stride-1 index picks the
schedule, as the reference's two Pallas kernels do: for layout_right a warp
per row with the lanes along j, for layout_left the lanes along i and the
block's warps (and, where the rows are few, several blocks) splitting j, 16
bytes a lane either way. ``ops.matvec`` picks the instantiation from the
MdSpan's layout type — "change the layout in the type, not the algorithm".

Sums in f32, output in x's dtype (A and x share the dtype on CUDA), in a
fixed order: repeated runs are bit-identical. Any shape and any element
alignment run: a buffer off a 16-byte boundary, or a stride-1 extent that is
no multiple of 16 bytes, takes the kernel's scalar-load form. On CPU tensors
a wrapper returns the plain version; on CUDA tensors it launches its kernel
or raises.
"""
from __future__ import annotations

import torch

from ._paper_suite import check_operands, launch
from .paged_attention import sm_count

LEFT_MIN_COLS = 256  # columns a left block takes at least (32 a warp)


def matvec_torch(a: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for logical A (I, J), in f32, cast to x's dtype."""
    return (a.float() @ x.float()).to(x.dtype)


def plan_matvec_left(rows: int, cols: int, elem_size: int, sms: int):
    """(splits, cols_per_split) of the left kernel: a block holds a run of
    32 * 16 / elem_size rows; where the runs fall short of two blocks a SM,
    j is cut into enough runs for that, each of at least LEFT_MIN_COLS
    columns.
    Depends on the shapes and the SM count only, so a result repeats bit for
    bit on one card."""
    runs = -(-rows // (32 * (16 // elem_size)))
    splits = max(1, min(-(-2 * sms // runs), cols // LEFT_MIN_COLS))
    per = max(1, -(-cols // splits))
    return max(1, -(-cols // per)), per


def _launch(buf: torch.Tensor, x: torch.Tensor, rows: int, layout: int, what: str):
    code = check_operands(what, buf, x)
    cols = x.shape[0]
    y = torch.empty(rows, dtype=x.dtype, device=x.device)
    if rows == 0:
        return y
    splits, per, ws = 1, max(1, cols), None
    if layout == 1:
        splits, per = plan_matvec_left(rows, cols, x.element_size(), sm_count(x.device))
        if splits > 1:
            ws = torch.empty(splits * rows, dtype=torch.float32, device=x.device)
    launch("repro_matvec", what, code, layout, buf.data_ptr(), x.data_ptr(), y.data_ptr(),
           ws.data_ptr() if ws is not None else None, rows, cols, splits, per, device=x.device)
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
