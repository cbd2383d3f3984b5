"""Quantized matmul: y = x @ dequant(W)^T with W stored output-major, int8 or
int4, one f32 scale per (row, K-block) — the compute backend of quantized
serving weights.

Port of ``repro.kernels.quant_matmul``:

  quant_matmul_torch  <- repro.kernels.ref.quant_matmul (the plain version)
  quant_matmul        <- quant_matmul (Pallas) — launches
                         csrc/quant_matmul.cu::quant_matmul_kernel

x: (M, K) float32 or bfloat16; q: (N, K) int8, or (N, K/2) int4 in ADJACENT
nibbles (byte j holds value 2j in the lo nibble and 2j + 1 in the hi — the
``core.distributed.quantize_array`` packing, not the KV pages' split-half
order); scale: (N, K / qblock) f32, qblock inferred from its shape. Sums in
f32, output in x's dtype. On CPU tensors the wrapper returns the plain
version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core.distributed import unpack_int4_adjacent

from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_QBLOCK = 256  # the kernel's K-step is the block; its shared tiles are sized for this


def quant_matmul_torch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                       bits: int = 8) -> torch.Tensor:
    """Plain version: dequantize W to f32 ((N, K) = float(q) * scale per
    K-block), then x @ W^T in f32, cast to x's dtype."""
    if bits == 4:
        q = unpack_int4_adjacent(q)
    n, k = q.shape
    nb = scale.shape[1]
    w = (q.float().reshape(n, nb, k // nb) * scale[:, :, None]).reshape(n, k)
    return (x.float() @ w.t()).to(x.dtype)


_p, _i = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Binding("quant_matmul", {
    "repro_quant_matmul": [_i, _i, _p, _p, _p, _p, _i, _i, _i, _i, _p],
})


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                 bits: int = 8) -> torch.Tensor:
    """y (M, N) = x (M, K) @ dequant(q, scale)^T (kernel: quant_matmul_kernel;
    its K-step is the quantization block, so one scale covers one staged
    tile)."""
    if x.device.type == "cpu":
        return quant_matmul_torch(x, q, scale, bits=bits)
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    for name, t, dtype in (("x", x, None), ("q", q, torch.int8), ("scale", scale, torch.float32)):
        if t.device != x.device or t.device.type != "cuda":
            raise ValueError(f"{name} must be a CUDA tensor on {x.device}, got {t.device}")
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got shape {tuple(t.shape)}")
        if dtype is not None and t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    m, k = x.shape
    n = q.shape[0]
    kq = q.shape[1] * 2 if bits == 4 else q.shape[1]
    nb = scale.shape[1]
    if kq != k or scale.shape[0] != n or nb <= 0 or k % nb:
        raise ValueError(
            f"shapes disagree: x {tuple(x.shape)}, q {tuple(q.shape)} (bits {bits}), "
            f"scale {tuple(scale.shape)}"
        )
    qblock = k // nb
    if qblock > MAX_QBLOCK or qblock % 2:
        raise ValueError(f"quantization block {qblock} must be even and <= {MAX_QBLOCK}")
    y = torch.empty((m, n), dtype=x.dtype, device=x.device)
    if m == 0:
        return y
    _LIB.launch(
        "repro_quant_matmul", "quant_matmul",
        _DTYPE_CODE[x.dtype], bits, x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        m, n, k, qblock, device=x.device,
    )
    quant_matmul.launches += 1
    return y


quant_matmul.launches = 0

KERNEL_WRAPPERS = {"quant_matmul": quant_matmul}
