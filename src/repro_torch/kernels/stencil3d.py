"""Stencil3D — 27-point box stencil (paper: Stencil3D, stencil size d=1).

Port of ``repro.kernels.stencil3d``:

  stencil3d_torch  <- repro.kernels.ref.stencil3d (the plain version)
  stencil3d        <- stencil3d_pallas — launches
                      csrc/paper_suite.cu::stencil3d_kernel

out[i, j, k] = the sum of x over the 3x3x3 box around (i, j, k) on the
interior; boundary entries (and every entry when I, J or K < 3) are 0. Sums
in f32, output in x's dtype. That follows the Pallas kernel; the reference's
oracle ``ref.stencil3d`` returns float32 for a bfloat16 input (a reference
quirk, ROADMAP Queue 3). On CPU tensors the wrapper returns the plain
version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ._paper_suite import check_operands, launch


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


def stencil3d(x: torch.Tensor) -> torch.Tensor:
    """The box stencil of a rank-3 tensor (kernel: one thread per output
    element, summing its 27 neighbours in the plain version's order)."""
    if x.dim() != 3:
        raise ValueError(f"stencil3d takes a rank-3 tensor, got shape {tuple(x.shape)}")
    if x.device.type == "cpu":
        return stencil3d_torch(x)
    code = check_operands("stencil3d", x)
    i, j, k = x.shape
    if i > 65535 or j > 8 * 65535:
        raise ValueError(f"stencil3d grid covers I <= 65535 and J <= 524280, got {tuple(x.shape)}")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    launch("repro_stencil3d", "stencil3d", code, x.data_ptr(), out.data_ptr(), i, j, k,
           device=x.device)
    stencil3d.launches += 1
    return out


stencil3d.launches = 0

KERNEL_WRAPPERS = {"stencil3d": stencil3d}
