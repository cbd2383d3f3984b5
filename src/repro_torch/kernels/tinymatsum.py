"""TinyMatrixSum — batched accumulate over (N, J, K) tiny matrices (paper Fig. 5).

Port of ``repro.kernels.tinymatsum``:

  tinymatsum_torch    <- repro.kernels.ref.tinymatsum (the plain version)
  plan_tinymatsum     the kernels' spans and grid (plain; no reference
                      namesake)
  tinymatsum_static   <- tinymatsum_static — launches csrc/paper_suite.cu::
                         tinymatsum_static_kernel<T, J, K>
  tinymatsum_dynamic  <- tinymatsum_dynamic — launches
                         tinymatsum_dynamic_kernel<T>

The paper's experiment: with the inner extents (3, 3) static, the compiler
fully unrolls and folds the index math, ~2x on a CPU. On the card the static
kernel takes J and K as template parameters (instantiated for 1..8 each;
other shapes raise on CUDA tensors) and the dynamic one as runtime ints. Both
are one body: a block stages contiguous spans of matrices through shared
memory (16-byte copies; the card's other blocks keep loads in flight
meanwhile), each thread sums its matrices by the (j, k) loop nest there, and
the block stores the span with 16-byte stores; so the measured gap is the
static-extent effect on that loop nest alone. A buffer off 16 bytes, or N J K
elements that are no multiple of 16 bytes, takes the same kernel's scalar
staging form. Dynamic matrices too large for a block's shared memory (f32:
J K past ~7264) take the dynamic kernel's unstaged form, a block a matrix
straight from global memory. The reference's dynamic kernel pads to a
(jmax, kmax) envelope for TPU sublane alignment; the port keeps ``jmax`` /
``kmax`` and their check for API parity but pads nothing.

f32 add, output in o's dtype. On CPU tensors a wrapper returns the plain
version; on CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from ._paper_suite import DTYPE_CODE, GEOMETRY, check_operands, launch, tinymatsum_blocks_per_sm
from .paged_attention import sm_count

MAX_STATIC_EXTENT = GEOMETRY["tiny_max_extent"]  # the static kernel's instantiated J, K
SPAN_BYTES = 8192  # bytes of one operand a span holds at most (more only where one unit does)


@dataclass(frozen=True)
class TinyPlan:
    """How the kernels walk (N, J, K): block b takes spans b, b + grid, ...
    of ``bn`` matrices, staged in shared memory (stage_bytes); bn 0 is the
    dynamic kernel's unstaged form (matrix b, b + grid, ...); ``vec`` picks
    the 16-byte copies over the scalar ones."""
    bn: int
    grid: int
    vec: bool


def tiny_stride(jk: int, elem_size: int) -> int:
    """Elements between two matrices in a stage (csrc/paper_suite.cu's
    tiny_stride): J K, plus 16 bytes where J K elements are an even number
    of 16-byte chunks (so that a warp's reads spread over the banks)."""
    nbytes = jk * elem_size
    return jk + 16 // elem_size if nbytes % 16 == 0 and (nbytes // 16) % 2 == 0 else jk


def stage_bytes(j: int, k: int, elem_size: int, bn: int) -> int:
    """Shared memory a block of the kernels takes: both operands' copies of
    ``bn`` matrices."""
    return 2 * bn * tiny_stride(j * k, elem_size) * elem_size


def plan_tinymatsum(n: int, j: int, k: int, elem_size: int, aligned: bool, sms: int,
                    resident: Callable[[int], int]) -> TinyPlan:
    """The plan for n (J, K) matrices of ``elem_size`` bytes; ``aligned``:
    o, s and out all lie on 16 bytes; ``resident(smem)``: blocks of the
    kernel with ``smem`` bytes of shared memory that fit on one SM at once
    (its occupancy, registers included).

    A span holds at most one matrix a thread and SPAN_BYTES of an operand,
    is a whole number of 16-byte chunks (so each span starts on 16 bytes
    where the base does), and is small enough that every SM gets one where n
    allows. As many blocks as the spans, at most as many as are resident at
    once, so that no block waits for a second wave. The vector form where
    ``aligned`` and n J K elements are whole chunks. Where even the fewest
    matrices that make whole chunks do not fit a block's shared memory, the
    unstaged form (bn 0, scalar). Depends on the shapes, the alignment, the
    SM count and the occupancy only."""
    jk = j * k
    unit = 16 // math.gcd(jk * elem_size, 16)  # matrices that make whole chunks
    if stage_bytes(j, k, elem_size, unit) > GEOMETRY["smem_opt_in"]:
        return TinyPlan(0, min(n, max(1, resident(0)) * sms), False)
    row = tiny_stride(jk, elem_size) * elem_size  # stage bytes of one matrix of one operand
    share = -(-n // sms)  # matrices an SM gets where every SM gets some
    most = min(SPAN_BYTES // row, GEOMETRY["threads"])
    bn = min(max(unit, most // unit * unit), -(-share // unit) * unit)
    grid = min(-(-n // bn), max(1, resident(stage_bytes(j, k, elem_size, bn))) * sms)
    vec = aligned and (n * jk * elem_size) % 16 == 0
    return TinyPlan(bn, grid, vec)


def tinymatsum_torch(o: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """o + s in f32, cast to o's dtype."""
    return (o.float() + s.float()).to(o.dtype)


def plan_for(o: torch.Tensor, s: torch.Tensor, out: torch.Tensor, is_static: bool) -> TinyPlan:
    """The plan the wrappers launch with for these CUDA tensors: their shape
    and alignment, the card's SM count and the kernel's occupancy."""
    n, j, k = o.shape
    code = DTYPE_CODE[o.dtype]
    aligned = all(t.data_ptr() % 16 == 0 for t in (o, s, out))
    return plan_tinymatsum(
        n, j, k, o.element_size(), aligned, sm_count(o.device),
        lambda smem: tinymatsum_blocks_per_sm(code, is_static, j, k, smem, o.device))


def _launch(o: torch.Tensor, s: torch.Tensor, is_static: bool, what: str,
            plan: Optional[TinyPlan]) -> torch.Tensor:
    if o.dim() != 3 or s.shape != o.shape:
        raise ValueError(f"{what} takes o, s of one (N, J, K) shape, got "
                         f"{tuple(o.shape)} and {tuple(s.shape)}")
    code = check_operands(what, o, s)
    n, j, k = o.shape
    out = torch.empty_like(o)
    if o.numel() == 0:
        return out
    if plan is None:
        plan = plan_for(o, s, out, is_static)
    launch("repro_tinymatsum", what, code, int(is_static), o.data_ptr(), s.data_ptr(),
           out.data_ptr(), n, j, k, plan.bn, plan.grid, int(plan.vec), device=o.device)
    return out


def tinymatsum_static(o: torch.Tensor, s: torch.Tensor, *,
                      plan: Optional[TinyPlan] = None) -> torch.Tensor:
    """o + s with J, K as template arguments of the kernel (static extents);
    ``plan`` (default: plan_tinymatsum's) sets the kernel's spans."""
    if o.device.type == "cpu":
        return tinymatsum_torch(o, s)
    _, j, k = o.shape
    if not (1 <= j <= MAX_STATIC_EXTENT and 1 <= k <= MAX_STATIC_EXTENT):
        raise ValueError(f"tinymatsum_static is instantiated for J, K in 1..{MAX_STATIC_EXTENT}, "
                         f"got ({j}, {k}); use tinymatsum_dynamic")
    out = _launch(o, s, True, "tinymatsum_static", plan)
    tinymatsum_static.launches += 1
    return out


def tinymatsum_dynamic(o: torch.Tensor, s: torch.Tensor, *, jmax: int = 8, kmax: int = 8,
                       plan: Optional[TinyPlan] = None) -> torch.Tensor:
    """o + s with J, K <= (jmax, kmax) known only at run time (dynamic extents);
    ``plan`` as for tinymatsum_static."""
    _, j, k = o.shape
    if not (j <= jmax and k <= kmax):
        raise ValueError(f"extents ({j}, {k}) exceed the envelope ({jmax}, {kmax})")
    if o.device.type == "cpu":
        return tinymatsum_torch(o, s)
    out = _launch(o, s, False, "tinymatsum_dynamic", plan)
    tinymatsum_dynamic.launches += 1
    return out


tinymatsum_static.launches = 0
tinymatsum_dynamic.launches = 0

KERNEL_WRAPPERS = {"tinymatsum_static": tinymatsum_static,
                   "tinymatsum_dynamic": tinymatsum_dynamic}
