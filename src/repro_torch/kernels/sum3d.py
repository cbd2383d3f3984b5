"""Sum3D — the paper's "simplest possible" benchmark, with a layout-generic entry.

Port of ``repro.kernels.sum3d``:

  sum3d_torch   <- repro.kernels.ref.sum3d (the plain version)
  sum3d         <- sum3d_pallas — launches csrc/paper_suite.cu::
                   sum3d_partials_kernel, then sum_partials_kernel
  sum3d_mdspan  <- sum3d_mdspan (the layout dispatch)

The algorithm (sum every entry) is layout-agnostic; the schedule follows the
buffer as stored. ``sum3d_mdspan`` reshapes the CODOMAIN into physical order
(LayoutRight: (I, J, K); LayoutLeft: (K, J, I), fast dim first) and the
kernel walks it as stored: no transpose, no copy. Other layouts are gathered
through the layout first (one pass).

The sum is f32 whatever the input type, and deterministic: per-block partials
in a fixed grid, then one fixed-order second pass (no float atomics). On CPU
tensors the wrapper returns the plain version; on CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from ._paper_suite import check_operands, launch

MAX_BLOCKS = 1024  # the first pass's grid (and partials scratch) at most


def sum3d_torch(x: torch.Tensor) -> torch.Tensor:
    """Sum of all entries, in f32 (a 0-d tensor)."""
    return torch.sum(x.float())


def sum3d(x: torch.Tensor) -> torch.Tensor:
    """Sum of a rank-3 tensor held in its PHYSICAL order, in f32 (a 0-d
    tensor); bit-identical from run to run on one card."""
    if x.dim() != 3:
        raise ValueError(f"sum3d takes a rank-3 tensor, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return sum3d_torch(x)
    code = check_operands("sum3d", x)
    partials = torch.empty(MAX_BLOCKS, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    launch("repro_sum3d", "sum3d", code, x.data_ptr(), x.numel(), partials.data_ptr(),
           MAX_BLOCKS, out.data_ptr(), device=x.device)
    sum3d.launches += 1
    return out


sum3d.launches = 0


def sum3d_mdspan(span) -> torch.Tensor:
    """Layout-generic entry point: an MdSpan whose layout decides the physical
    schedule. Row/column-major layouts reshape the codomain to the physical
    order (a view) and run the same kernel on it."""
    from repro_torch.core.layouts import LayoutLeft, LayoutRight
    from repro_torch.core.mdspan import MdSpan

    if not isinstance(span, MdSpan) or span.rank != 3:
        raise TypeError("sum3d_mdspan takes a rank-3 MdSpan")
    if isinstance(span.layout, LayoutRight):
        phys = span.codomain().reshape(span.shape)
    elif isinstance(span.layout, LayoutLeft):
        phys = span.codomain().reshape(span.shape[::-1])  # physical order: fast dim first
    else:
        phys = span.to_dense()  # generic: gather through the layout (one pass)
    return sum3d(phys)


KERNEL_WRAPPERS = {"sum3d": sum3d}
