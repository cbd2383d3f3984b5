"""Quantized matmul: y = x @ dequant(W)^T with W stored output-major, int8 or
int4, one f32 scale per (row, K-block) — the compute backend of quantized
serving weights.

Port of ``repro.kernels.quant_matmul``:

  quant_matmul_torch  <- repro.kernels.ref.quant_matmul (the plain version)
  quant_matmul        <- quant_matmul (Pallas) — launches
                         csrc/quant_matmul.cu's qmm_stream_kernel (bf16
                         x, M <= 16), qmm_mma_kernel (bf16 x, M > 16) or
                         qmm_fma_kernel (the rest), as plan_quant_matmul
                         picks

x: (M, K) float32 or bfloat16; q: (N, K) int8, or (N, K/2) int4 in ADJACENT
nibbles (byte j holds value 2j in the lo nibble and 2j + 1 in the hi — the
``core.distributed.quantize_array`` packing, not the KV pages' split-half
order); scale: (N, K / qblock) f32, qblock inferred from its shape. Sums in
f32, output in x's dtype. On CPU tensors the wrapper returns the plain
version; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core.distributed import unpack_int4_adjacent

from . import _build
from .paged_attention import sm_count

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_QBLOCK = 256  # the fma schedule's K-step is the block; its shared tiles are sized for this


class QmmPlan(NamedTuple):
    """The kernel's schedule for one call: ``schedule`` "stream" (M <= 16,
    bf16 x: q streamed into tensor-core fragments), "mma" (M > 16, bf16 x,
    tensor cores) or "fma" (CUDA cores: f32 x, and what the other two do not
    take), and K cut into ``splits`` runs of ``k_per_split`` (a multiple of
    the quantization block) summed in split order."""
    schedule: str
    splits: int
    k_per_split: int


SCHEDULES = {"stream": 0, "mma": 1, "fma": 2}
# csrc/quant_matmul.cu's kGeometry, in its order; the library is checked
# against it when it loads
GEOMETRY = {
    "stream_span_int8": 64, "stream_span_int4": 128,  # values a quad of lanes loads
    "stream_slice_int8": 256, "stream_slice_int4": 256,  # values a warp takes
    "stream_max_warps": 16,
    "mma_rows": 32, "mma_cols": 64, "mma_k_step": 64,
    "fma_cols": 64, "fma_rows_decode": 16, "fma_rows": 64,  # rows at M <= 16, above
}


def plan_quant_matmul(m: int, n: int, k: int, qblock: int, bits: int, dtype: torch.dtype,
                      sm_count: int, aligned: bool = True) -> QmmPlan:
    """The schedule and the K split for (M, K) x (N, K)^T. The tensor-core
    schedules take bf16 x with ``aligned`` operands (x and q on 16 bytes)
    and rows of 16-byte multiples: stream at M <= 16 with qblock a multiple
    of its span (64 values int8, 128 int4), mma at M > 16 with qblock a
    multiple of 16. Everything else runs fma. stream gives a block 8 rows of
    q and up to 16 warps of 256 values of K each, and splits K over blocks
    only past that; mma and fma split K so that the card gets ~2 blocks a SM
    (mma) or ~1 (fma), in runs of whole quantization blocks (for mma whole
    64-value K-steps). Depends only on shapes, dtype, alignment and the SM
    count."""
    g = GEOMETRY
    sfx = "int8" if bits == 8 else "int4"
    row_bytes = k if bits == 8 else k // 2
    tensor_cores = (dtype == torch.bfloat16 and aligned and row_bytes % 16 == 0
                    and k % 8 == 0)
    if m <= 16 and tensor_cores and qblock % g[f"stream_span_{sfx}"] == 0:
        slice_ = g[f"stream_slice_{sfx}"]
        unit = math.lcm(qblock, slice_)
        units = -(-k // unit)
        per_split = max(1, g["stream_max_warps"] // (unit // slice_))
        splits = -(-units // per_split)
        per = -(-units // splits) * unit
        return QmmPlan("stream", -(-k // per), per)
    if m > 16 and tensor_cores and qblock % 16 == 0:
        schedule, unit = "mma", math.lcm(qblock, g["mma_k_step"])
        blocks, want = -(-n // g["mma_cols"]) * -(-m // g["mma_rows"]), 2 * sm_count
    else:
        rows = g["fma_rows_decode"] if m <= 16 else g["fma_rows"]
        schedule, unit = "fma", qblock
        blocks, want = -(-n // g["fma_cols"]) * -(-m // rows), sm_count
    units = -(-k // unit)
    splits = max(1, min(-(-want // blocks), units))
    per = -(-units // splits) * unit
    return QmmPlan(schedule, -(-k // per), per)


def quant_matmul_torch(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                       bits: int = 8, plan: Optional[QmmPlan] = None) -> torch.Tensor:
    """Plain version: dequantize W to f32 ((N, K) = float(q) * scale per
    K-block), then x @ W^T in f32, cast to x's dtype.

    With ``plan`` it mirrors the kernel's schedule instead: for "stream"
    and "mma" the scale comes out of the product (each K-block's f32
    sum of x * q, times its scale), for "fma" W is dequantized first; each
    K-split's partial is summed over its blocks and the splits are added in
    order."""
    if bits == 4:
        q = unpack_int4_adjacent(q)
    n, k = q.shape
    nb = scale.shape[1]
    qb = k // nb
    if plan is None:
        w = (q.float().reshape(n, nb, qb) * scale[:, :, None]).reshape(n, k)
        return (x.float() @ w.t()).to(x.dtype)
    m = x.shape[0]
    xs = x.float().reshape(m, nb, qb)
    if plan.schedule == "fma":
        wq = q.float().reshape(n, nb, qb) * scale[:, :, None]
        part = torch.einsum("mbk,nbk->mnb", xs, wq)
    else:
        part = torch.einsum("mbk,nbk->mnb", xs, q.float().reshape(n, nb, qb)) * scale[None]
    per = plan.k_per_split // qb
    y = torch.zeros((m, n), dtype=torch.float32, device=x.device)
    for s in range(plan.splits):
        y = y + part[:, :, s * per:(s + 1) * per].sum(dim=-1)
    return y.to(x.dtype)


_p, _i = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Binding("quant_matmul", {
    "repro_quant_matmul": [_i, _i, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _p],
}, geometry=GEOMETRY)


def quant_matmul(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor, *,
                 bits: int = 8) -> torch.Tensor:
    """y (M, N) = x (M, K) @ dequant(q, scale)^T (kernels: qmm_stream_kernel
    for bf16 x at M <= 16, qmm_mma_kernel for bf16 x at M > 16,
    qmm_fma_kernel otherwise, as plan_quant_matmul picks; split K summed in
    order by qmm_sum_splits_kernel). The plan of the last launch is left in
    ``quant_matmul.last_plan``."""
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
    aligned = x.data_ptr() % 16 == 0 and q.data_ptr() % 16 == 0
    plan = plan_quant_matmul(m, n, k, qblock, bits, x.dtype, sm_count(x.device), aligned)
    ws = (torch.empty(plan.splits * m * n, dtype=torch.float32, device=x.device)
          if plan.splits > 1 else None)
    _LIB.launch(
        "repro_quant_matmul", "quant_matmul",
        _DTYPE_CODE[x.dtype], bits, x.data_ptr(), q.data_ptr(), scale.data_ptr(), y.data_ptr(),
        ws.data_ptr() if ws is not None else None, m, n, k, qblock, SCHEDULES[plan.schedule],
        plan.splits, plan.k_per_split, device=x.device,
    )
    quant_matmul.launches += 1
    quant_matmul.last_plan = plan
    return y


quant_matmul.launches = 0
quant_matmul.last_plan = None

KERNEL_WRAPPERS = {"quant_matmul": quant_matmul}
