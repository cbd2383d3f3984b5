"""The binding of ``csrc/paper_suite.cu`` (the paper-suite kernels), shared by
the sum3d, stencil3d, tinymatsum and matvec wrappers. The library is built by
``_build`` on the first launch; nothing is built or loaded at import."""
from __future__ import annotations

import ctypes

import torch

from . import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LIB = _build.Binding("paper_suite", {
    "repro_sum3d": [_I, _P, _L, _P, _I, _P, _P],
    "repro_stencil3d": [_I, _P, _P, _I, _I, _I, _P],
    "repro_tinymatsum": [_I, _I, _P, _P, _P, _L, _I, _I, _P],
    "repro_matvec": [_I, _I, _P, _P, _P, _I, _I, _P],
})
launch = LIB.launch


def check_operands(what: str, *tensors: torch.Tensor) -> int:
    """Every operand a contiguous CUDA tensor on one device, of one dtype the
    kernels take; returns that dtype's code."""
    first = tensors[0]
    for t in tensors:
        if t.device.type != "cuda" or t.device != first.device:
            raise ValueError(f"{what}: operands must be CUDA tensors on one device, got {t.device}")
        if t.dtype != first.dtype:
            raise TypeError(f"{what}: operands must share a dtype, got {first.dtype} and {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: operands must be contiguous (the kernel reads the "
                             "buffer as stored)")
    if first.dtype not in DTYPE_CODE:
        raise TypeError(f"{what}: dtype must be float32 or bfloat16, got {first.dtype}")
    return DTYPE_CODE[first.dtype]

