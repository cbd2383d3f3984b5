"""TinyMatrixSum — batched accumulate over (N, J, K) tiny matrices (paper Fig. 5).

Port of ``repro.kernels.tinymatsum``:

  tinymatsum_torch    <- repro.kernels.ref.tinymatsum (the plain version)
  tinymatsum_static   <- tinymatsum_static — launches csrc/paper_suite.cu::
                         tinymatsum_static_kernel<T, J, K>
  tinymatsum_dynamic  <- tinymatsum_dynamic — launches
                         tinymatsum_dynamic_kernel<T>

The paper's experiment: with the inner extents (3, 3) static, the compiler
fully unrolls and folds the index math, ~2x on a CPU. On the card the static
kernel takes J and K as template parameters (instantiated for 1..8 each;
other shapes raise on CUDA tensors) and the dynamic one as runtime ints;
both run one thread per matrix over the same unpadded buffers, so the
measured gap is the static-extent effect alone. The reference's dynamic
kernel pads to a (jmax, kmax) envelope for TPU sublane alignment; the port
keeps ``jmax`` / ``kmax`` and their check for API parity but pads nothing.

f32 add, output in o's dtype. On CPU tensors a wrapper returns the plain
version; on CUDA tensors it launches its kernel or raises.
"""
from __future__ import annotations

import torch

from ._paper_suite import check_operands, launch

MAX_STATIC_EXTENT = 8  # the static kernel's instantiated J, K: 1..8


def tinymatsum_torch(o: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """o + s in f32, cast to o's dtype."""
    return (o.float() + s.float()).to(o.dtype)


def _launch(o: torch.Tensor, s: torch.Tensor, is_static: bool, what: str) -> torch.Tensor:
    if o.dim() != 3 or s.shape != o.shape:
        raise ValueError(f"{what} takes o, s of one (N, J, K) shape, got "
                         f"{tuple(o.shape)} and {tuple(s.shape)}")
    code = check_operands(what, o, s)
    n, j, k = o.shape
    out = torch.empty_like(o)
    if o.numel() == 0:
        return out
    launch("repro_tinymatsum", what, code, int(is_static), o.data_ptr(), s.data_ptr(),
           out.data_ptr(), n, j, k, device=o.device)
    return out


def tinymatsum_static(o: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """o + s with J, K as template arguments of the kernel (static extents)."""
    if o.device.type == "cpu":
        return tinymatsum_torch(o, s)
    _, j, k = o.shape
    if not (1 <= j <= MAX_STATIC_EXTENT and 1 <= k <= MAX_STATIC_EXTENT):
        raise ValueError(f"tinymatsum_static is instantiated for J, K in 1..{MAX_STATIC_EXTENT}, "
                         f"got ({j}, {k}); use tinymatsum_dynamic")
    out = _launch(o, s, True, "tinymatsum_static")
    tinymatsum_static.launches += 1
    return out


def tinymatsum_dynamic(o: torch.Tensor, s: torch.Tensor, *, jmax: int = 8,
                       kmax: int = 8) -> torch.Tensor:
    """o + s with J, K <= (jmax, kmax) known only at run time (dynamic extents)."""
    _, j, k = o.shape
    if not (j <= jmax and k <= kmax):
        raise ValueError(f"extents ({j}, {k}) exceed the envelope ({jmax}, {kmax})")
    if o.device.type == "cpu":
        return tinymatsum_torch(o, s)
    out = _launch(o, s, False, "tinymatsum_dynamic")
    tinymatsum_dynamic.launches += 1
    return out


tinymatsum_static.launches = 0
tinymatsum_dynamic.launches = 0

KERNEL_WRAPPERS = {"tinymatsum_static": tinymatsum_static,
                   "tinymatsum_dynamic": tinymatsum_dynamic}
