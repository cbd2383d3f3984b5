"""Sum3D — the paper's "simplest possible" benchmark, with a layout-generic entry.

Port of ``repro.kernels.sum3d``:

  sum3d_torch   <- repro.kernels.ref.sum3d (the plain version)
  plan_sum3d    the kernel's grid (plain; no reference namesake)
  sum3d         <- sum3d_pallas — launches csrc/paper_suite.cu::sum3d_kernel
  sum3d_mdspan  <- sum3d_mdspan (the layout dispatch)

The algorithm (sum every entry) is layout-agnostic; the schedule follows the
buffer as stored. ``sum3d_mdspan`` reshapes the CODOMAIN into physical order
(LayoutRight: (I, J, K); LayoutLeft: (K, J, I), fast dim first) and the
kernel walks it as stored: no transpose, no copy. Other layouts are gathered
through the layout first (one pass).

The sum is f32 whatever the input type, and deterministic: one cooperative
launch, each block's partial written to scratch, the grid synchronized, and
the partials folded in index order by block 0 (no float atomics); the grid
depends on the size and the card only, so repeated runs are bit-identical.
The kernel reads 16-byte vectors from the first 16-byte boundary on and
adds the elements before it and after the last whole vector one a thread,
so any alignment takes it. On CPU
tensors the wrapper returns the plain version; on CUDA tensors it launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from ._paper_suite import DTYPE_CODE, GEOMETRY, check_operands, launch, sum3d_blocks_per_sm
from .common import no_grad_through
from .paged_attention import sm_count

THREADS = GEOMETRY["sum3d_threads"]
VEC_BYTES = GEOMETRY["sum3d_vector_bytes"]
VECS = GEOMETRY["sum3d_vectors"]  # vectors in flight a thread: one step of the walk


def sum3d_torch(x: torch.Tensor) -> torch.Tensor:
    """Sum of all entries, in f32 (a 0-d tensor)."""
    return torch.sum(x.float())


def plan_sum3d(n: int, elem_size: int, sms: int, resident: int) -> int:
    """The kernel's grid for n elements of ``elem_size`` bytes; ``resident``:
    the kernel's blocks that fit on one SM at once (its occupancy). The
    card's resident blocks (one wave, so the cooperative launch holds it), or
    fewer where the buffer's 16-byte vectors do not give each block one whole
    step (VECS vectors a thread); at least 1. Depends on its arguments only."""
    steps = -(-(n * elem_size // VEC_BYTES) // (THREADS * VECS))
    return max(1, min(max(1, resident) * sms, steps))


def grid_for(x: torch.Tensor) -> int:
    """The grid the wrapper launches for this CUDA tensor: its size, the
    card's SM count and the kernel's occupancy."""
    return plan_sum3d(x.numel(), x.element_size(), sm_count(x.device),
                      sum3d_blocks_per_sm(DTYPE_CODE[x.dtype], x.device))


def sum3d(x: torch.Tensor) -> torch.Tensor:
    """Sum of a rank-3 tensor held in its PHYSICAL order, in f32 (a 0-d
    tensor); bit-identical from run to run on one card."""
    if x.dim() != 3:
        raise ValueError(f"sum3d takes a rank-3 tensor, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return sum3d_torch(x)
    no_grad_through("sum3d", x)
    code = check_operands("sum3d", x)
    grid = grid_for(x)
    partials = torch.empty(grid, dtype=torch.float32, device=x.device)
    out = torch.empty((), dtype=torch.float32, device=x.device)
    launch("repro_sum3d", "sum3d", code, x.data_ptr(), x.numel(), grid, partials.data_ptr(),
           out.data_ptr(), device=x.device)
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
