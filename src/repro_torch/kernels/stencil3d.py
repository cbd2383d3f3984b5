"""Stencil3D — 27-point box stencil (paper: Stencil3D, stencil size d=1).

Port of ``repro.kernels.stencil3d``:

  stencil3d_torch  <- repro.kernels.ref.stencil3d (the plain version)
  plan_stencil3d   the kernel's run length and grid (plain; no reference
                   namesake)
  stencil3d        <- stencil3d_pallas — launches
                      csrc/paper_suite.cu::stencil3d_kernel

out[i, j, k] = the sum of x over the 3x3x3 box around (i, j, k) on the
interior; boundary entries (and every entry when I, J or K < 3) are 0. Sums
in f32, output in x's dtype. That follows the Pallas kernel; the reference's
oracle ``ref.stencil3d`` returns float32 for a bfloat16 input (a reference
quirk, ROADMAP Queue 3). On CPU tensors the wrapper returns the plain
version; on CUDA tensors it launches the kernel or raises.

The kernel: a block owns a (j, k) tile and walks a run of i-planes, staging
each input plane's haloed window in shared memory planes ahead of use; each
thread keeps the neighbourhoods of its GEOMETRY["stencil_rows"] outputs (one
k, consecutive j) over three planes in registers and sums each output's 27
values from 0 in the plain version's order (di, dj, dk), so the output
equals ``stencil3d_torch`` bit for bit. ``plan_stencil3d`` picks the run length so
that the grid is one wave of the card (the SM count and the library's
occupancy query) where I allows.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ._paper_suite import DTYPE_CODE, GEOMETRY, check_operands, launch, stencil3d_blocks_per_sm
from .paged_attention import sm_count

TILE_J, TILE_K = GEOMETRY["stencil_tile_j"], GEOMETRY["stencil_tile_k"]
MAX_RUN = GEOMETRY["stencil_run"]
MAX_GRID_YZ = 65535  # the grid's y (j-tiles) and z (runs) on the card
MAX_I, MAX_J = MAX_RUN * MAX_GRID_YZ, TILE_J * MAX_GRID_YZ


def stencil3d_torch(x: torch.Tensor) -> torch.Tensor:
    """The 27-point box sum on the interior, 0 on the boundary, in x's dtype."""
    xf = x.float()
    out = torch.zeros_like(xf)
    i, j, k = x.shape
    if min(i, j, k) >= 3:
        acc = torch.zeros_like(xf[1:-1, 1:-1, 1:-1])
        for di in (-1, 0, 1):
            for dj in (-1, 0, 1):
                for dk in (-1, 0, 1):
                    acc = acc + xf[1 + di:i - 1 + di, 1 + dj:j - 1 + dj, 1 + dk:k - 1 + dk]
        out[1:-1, 1:-1, 1:-1] = acc
    return out.to(x.dtype)


@dataclass(frozen=True)
class StencilPlan:
    """How the kernel walks (I, J, K): block (kt, jt, r) owns the outputs
    j in [jt TILE_J, (jt + 1) TILE_J), k in [kt TILE_K, (kt + 1) TILE_K) of
    the planes [r run, (r + 1) run) (clipped to the array)."""
    run: int
    tiles_j: int
    tiles_k: int
    runs: int

    @property
    def blocks(self) -> int:
        return self.tiles_k * self.tiles_j * self.runs


def check_reach(shape) -> None:
    """Raise where the kernel's grid cannot cover an (I, J, K) array: its y
    (J / TILE_J tiles) and z (I / MAX_RUN runs) reach MAX_GRID_YZ."""
    i, j, _ = shape
    if i > MAX_I or j > MAX_J:
        raise ValueError(f"stencil3d grid covers I <= {MAX_I} and J <= {MAX_J}, got "
                         f"{tuple(shape)}")


def plan_stencil3d(i: int, j: int, k: int, sms: int, resident: int) -> StencilPlan:
    """The plan for an (I, J, K) array; ``resident``: blocks of the kernel
    that fit on one SM at once (its occupancy). The shortest runs (at most
    MAX_RUN planes) whose blocks all fit the card's resident slots at once:
    one wave, as many blocks as that allows. A second, partial wave would
    cost a whole run's time (scripts/time_rglru_stencil.py --variants times
    the runs at 96^3). Raises where the grid cannot cover the array
    (``check_reach``). Depends on the shape, the SM count and the occupancy
    only."""
    check_reach((i, j, k))
    tiles_j, tiles_k = -(-j // TILE_J), -(-k // TILE_K)
    max_runs = max(1, max(1, resident) * sms // (tiles_j * tiles_k))  # runs of one wave
    run = max(1, min(MAX_RUN, -(-i // max_runs)))
    return StencilPlan(run, tiles_j, tiles_k, -(-i // run))


def plan_for(x: torch.Tensor) -> StencilPlan:
    """The plan the wrapper launches with for this CUDA tensor: its shape, the
    card's SM count and the kernel's occupancy."""
    return plan_stencil3d(*x.shape, sm_count(x.device),
                          stencil3d_blocks_per_sm(DTYPE_CODE[x.dtype], x.device))


def stencil3d(x: torch.Tensor) -> torch.Tensor:
    """The box stencil of a rank-3 tensor (kernel: a block a (j, k) tile and a
    run of i-planes staged in shared memory, each output summing its 27
    neighbours in the plain version's order; the run from ``plan_for``)."""
    if x.dim() != 3:
        raise ValueError(f"stencil3d takes a rank-3 tensor, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return stencil3d_torch(x)
    code = check_operands("stencil3d", x)
    i, j, k = x.shape
    check_reach((i, j, k))
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    plan = plan_for(x)
    launch("repro_stencil3d", "stencil3d", code, x.data_ptr(), out.data_ptr(), i, j, k,
           plan.run, device=x.device)
    stencil3d.launches += 1
    return out


stencil3d.launches = 0

KERNEL_WRAPPERS = {"stencil3d": stencil3d}
