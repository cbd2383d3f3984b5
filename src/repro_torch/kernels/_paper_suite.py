"""The binding of ``csrc/paper_suite.cu`` (the paper-suite kernels), shared by
the sum3d, stencil3d, tinymatsum and matvec wrappers. The library is built by
``_build`` on the first launch, and GEOMETRY is checked against it then;
nothing is built or loaded at import."""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}

# csrc/paper_suite.cu's kGeometry, in its order: what tinymatsum's planner
# assumes of the library (threads a block, shared memory a block without and
# with the opt-in, the static kernel's largest J and K, and tiny_stride at
# 8 x 8 f32, 4 x 4 bf16 and 3 x 3 f32), then what the stencil's planner does
# (its tile of j and k, the j-rows of a thread, its longest run of i-planes,
# the planes of its ring, its threads a block), then what sum3d's planner
# does (threads a block, the bytes of a vector load, vectors in flight a
# thread)
GEOMETRY = {
    "threads": 256, "smem_default": 48 * 1024, "smem_opt_in": 232448,
    "tiny_max_extent": 8, "tiny_stride_8x8_f32": 68, "tiny_stride_4x4_bf16": 24,
    "tiny_stride_3x3_f32": 9, "stencil_tile_j": 8, "stencil_tile_k": 64, "stencil_rows": 4,
    "stencil_run": 32, "stencil_planes": 4, "stencil_threads": 128,
    "sum3d_threads": 256, "sum3d_vector_bytes": 16, "sum3d_vectors": 4,
}

_P, _I, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
LIB = _build.Binding("paper_suite", {
    "repro_sum3d": [_I, _P, _L, _I, _P, _P, _P],
    "repro_sum3d_blocks_per_sm": [_I, ctypes.POINTER(_I)],  # no stream
    "repro_stencil3d": [_I, _P, _P, _I, _I, _I, _I, _P],
    "repro_stencil3d_blocks_per_sm": [_I, ctypes.POINTER(_I)],  # no stream
    "repro_tinymatsum": [_I, _I, _P, _P, _P, _L, _I, _I, _I, _I, _I, _P],
    "repro_tinymatsum_blocks_per_sm": [_I, _I, _I, _I, _L, ctypes.POINTER(_I)],  # no stream
    "repro_matvec": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _P],
}, geometry=GEOMETRY)
launch = LIB.launch


@functools.lru_cache(maxsize=1024)
def tinymatsum_blocks_per_sm(code: int, is_static: bool, j: int, k: int, smem: int,
                             device: torch.device) -> int:
    """Blocks of the tinymatsum kernel for (dtype code, is_static, J, K) with
    ``smem`` bytes of shared memory that fit on one SM of ``device`` at once,
    registers included (the library's occupancy query), asked once each."""
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = LIB.lib().repro_tinymatsum_blocks_per_sm(code, int(is_static), j, k, smem,
                                                      ctypes.byref(out))
    if rc != 0:
        msg = LIB.lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"tinymatsum occupancy query failed: CUDA error {rc} ({msg})")
    return out.value


def _blocks_per_sm(what: str, code: int, device: torch.device) -> int:
    out = ctypes.c_int(0)
    with torch.cuda.device(device):
        rc = getattr(LIB.lib(), f"repro_{what}_blocks_per_sm")(code, ctypes.byref(out))
    if rc != 0:
        msg = LIB.lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} occupancy query failed: CUDA error {rc} ({msg})")
    return out.value


@functools.lru_cache(maxsize=16)
def stencil3d_blocks_per_sm(code: int, device: torch.device) -> int:
    """Blocks of the stencil kernel for dtype code ``code`` that fit on one SM
    of ``device`` at once, registers and its ring included (the library's
    occupancy query), asked once each."""
    return _blocks_per_sm("stencil3d", code, device)


@functools.lru_cache(maxsize=16)
def sum3d_blocks_per_sm(code: int, device: torch.device) -> int:
    """Blocks of the Sum3D kernel for dtype code ``code`` that fit on one SM
    of ``device`` at once (the library's occupancy query), asked once each."""
    return _blocks_per_sm("sum3d", code, device)


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

