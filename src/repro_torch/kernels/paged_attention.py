"""Paged GQA attention over a block-table KV pool: plain PyTorch versions and
the wrappers that launch the hand-written CUDA kernels.

The KV cache is a pool of fixed-size pages, (num_pages, Hkv, page_size, D);
row b of ``block_tables`` maps sequence b's logical page j to a physical page
(entries past the sequence's allocation point at the reserved null page 0).
This is the port of ``repro.kernels.paged_attention``:

  paged_decode_attention_torch   <- paged_decode_attention_jnp (unblocked and
                                    blocked forms)
  paged_prefill_chunk_torch      <- paged_prefill_chunk_jnp
  paged_flash_decode             <- paged_flash_decode (Pallas) — launches
                                    csrc/paged_attention.cu::paged_decode_kernel
  paged_flash_prefill_chunk      <- paged_flash_prefill_chunk (Pallas) —
                                    launches paged_chunk_kernel

and over quantized pools (int8 or int4 page bytes with one f32 scale per
(physical page, KV head), serving.engine.kvquant.PagedQuantSpec's encoding):

  pack_int4_splithalf, unpack_int4_splithalf, dequantize_pages
  paged_decode_attention_quant_torch   <- paged_decode_attention_quant_jnp
  paged_prefill_chunk_quant_torch      <- paged_prefill_chunk_quant_jnp
  paged_flash_decode_quant             <- paged_flash_decode_quant (Pallas) —
                                          the decode kernel over intN pages
  paged_flash_prefill_chunk_quant      <- paged_flash_prefill_chunk_quant
                                          (Pallas) — the chunk kernel, past
                                          over intN pages

A wrapper given CUDA tensors launches its kernel (or raises on what the kernel
does not take); given CPU tensors it returns its plain version, which is how
the CPU tests reach it. Nothing falls back from the kernel to the plain
version. Each wrapper counts its launches in ``.launches`` (a plain int) so a
run can show that the serving path went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from repro_torch.core.distributed import as_int8_bits, signed_nibble

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------------
# int4 nibble packing (split-half) and page dequantization
# ---------------------------------------------------------------------------------
def pack_int4_splithalf(q: torch.Tensor) -> torch.Tensor:
    """Signed int4 values (last dim D even) two per byte, split-half: byte d
    holds value d in the lo nibble and value d + D/2 in the hi nibble, so a
    token's K/V row maps to whole bytes of its own."""
    d = q.shape[-1]
    q = q.to(torch.int16)
    return as_int8_bits((q[..., :d // 2] & 0x0F) | ((q[..., d // 2:] & 0x0F) << 4))


def unpack_int4_splithalf(b: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4_splithalf, sign-extending each nibble."""
    return torch.cat([signed_nibble(b & 0x0F), signed_nibble((b >> 4) & 0x0F)], dim=-1)


def dequantize_pages(q: torch.Tensor, scale: torch.Tensor, *, bits: int) -> torch.Tensor:
    """q: (..., page_size, Dq) intN bytes; scale: (...) f32 per (page, head).
    Returns f32 (..., page_size, D): float(q) * scale."""
    if bits == 4:
        q = unpack_int4_splithalf(q)
    return q.float() * scale[..., None, None]


# ---------------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------------
def _safe(l: torch.Tensor) -> torch.Tensor:
    return torch.where(l == 0.0, torch.ones_like(l), l)


def _gather_pages(pool: torch.Tensor, block_tables: torch.Tensor) -> torch.Tensor:
    """(B, Hkv, max_pages * ps, D): each sequence's pages gathered by table."""
    b, max_pages = block_tables.shape
    _, hkv, ps, d = pool.shape
    g = pool[block_tables.long()]  # (B, max_pages, Hkv, ps, D)
    return g.movedim(2, 1).reshape(b, hkv, max_pages * ps, d)


def paged_decode_attention_torch(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    scale: Optional[float] = None,
    block_pages: Optional[int] = None,
) -> torch.Tensor:
    """One-token GQA decode: gather pages by table, mask by length.

    q: (B, Hq, 1, D); pools (num_pages, Hkv, ps, D); block_tables (B,
    max_pages) int; context_lens (B,) int, positions < context_lens[b] attend.
    Rows with length 0 output exact zeros. With ``block_pages`` set below
    max_pages the gather is blocked (an online softmax over page blocks of
    that width), bounding the gathered working set; the result is the same.
    """
    b, hq, tq, d = q.shape
    _, hkv, ps, _ = k_pool.shape
    if tq != 1 or hq % hkv:
        raise ValueError(f"decode wants q (B, Hq, 1, D) with Hq % Hkv == 0, got {tuple(q.shape)}")
    group = hq // hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    max_pages = block_tables.shape[1]
    if block_pages and block_pages < max_pages:
        return _paged_decode_torch_blocked(
            q, k_pool, v_pool, block_tables, context_lens,
            scale=scale, block_pages=int(block_pages),
        )
    k = _gather_pages(k_pool, block_tables).float()
    v = _gather_pages(v_pool, block_tables).float()
    s_len = k.shape[2]
    qg = q.reshape(b, hkv, group, d).float()
    s = torch.einsum("bhgd,bhkd->bhgk", qg, k) * scale
    live = (torch.arange(s_len, device=q.device)[None, :] < context_lens[:, None])[:, None, None, :]
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * live
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgk,bhkd->bhgd", p, v) / _safe(l)
    return out.reshape(b, hq, 1, d).to(q.dtype)


def _paged_decode_torch_blocked(q, k_pool, v_pool, block_tables, context_lens, *,
                                scale: float, block_pages: int) -> torch.Tensor:
    """Blocked form: loop over page blocks with an online-softmax (m, l, acc)
    carry. The table is padded to whole blocks with the null page 0, padded
    positions are dead, and dead scores are zeroed through ``* live`` rather
    than through exp() (exp(NEG_INF - NEG_INF) == 1 on an all-dead block)."""
    b, hq, _, d = q.shape
    _, hkv, ps, _ = k_pool.shape
    group = hq // hkv
    max_pages = block_tables.shape[1]
    nb = -(-max_pages // block_pages)
    pad = nb * block_pages - max_pages
    bt = torch.nn.functional.pad(block_tables, (0, pad))  # null page 0 in the tail
    qg = q.reshape(b, hkv, group, d).float()
    s_blk = block_pages * ps
    m = torch.full((b, hkv, group, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hkv, group, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hkv, group, d), dtype=torch.float32, device=q.device)
    for jb in range(nb):
        cols = bt[:, jb * block_pages:(jb + 1) * block_pages]
        k = _gather_pages(k_pool, cols).float()
        v = _gather_pages(v_pool, cols).float()
        s = torch.einsum("bhgd,bhkd->bhgk", qg, k) * scale
        pos = jb * s_blk + torch.arange(s_blk, device=q.device)
        live = (pos[None, :] < context_lens[:, None]) & (pos < max_pages * ps)[None, :]
        live = live[:, None, None, :]
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * live
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhgk,bhkd->bhgd", p, v)
        m = m_new
    return (acc / _safe(l)).reshape(b, hq, 1, d).to(q.dtype)


def paged_prefill_chunk_torch(
    q: torch.Tensor,
    chunk_k: torch.Tensor,
    chunk_v: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    cursors: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill GQA attention: [gathered past pages | the chunk's own
    K/V] along the key axis, past live below the cursor, present causal, one
    softmax. q: (B, Hq, C, D) at positions cursors[b] .. cursors[b] + C - 1;
    chunk_k/chunk_v: (B, Hkv, C, D); cursors: (B,) tokens resident before the
    chunk (the pool is read only below it)."""
    b, hq, c, d = q.shape
    _, hkv, ps, _ = k_pool.shape
    if hq % hkv:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {hkv}")
    group = hq // hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    k = _gather_pages(k_pool, block_tables)
    v = _gather_pages(v_pool, block_tables)
    s_len = k.shape[2]
    k = torch.cat([k, chunk_k.to(k.dtype)], dim=2).float()
    v = torch.cat([v, chunk_v.to(v.dtype)], dim=2).float()
    qg = q.reshape(b, hkv, group, c, d).float()
    s = torch.einsum("bhgqd,bhkd->bhgqk", qg, k) * scale
    t_q = torch.arange(c, device=q.device)
    past = torch.arange(s_len, device=q.device)[None, None, :] < cursors[:, None, None]
    past = past.expand(b, c, s_len)
    present = (t_q[None, :] <= t_q[:, None])[None].expand(b, c, c)
    live = torch.cat([past, present], dim=-1)[:, None, None]  # (B, 1, 1, C, S + C)
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m) * live
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhgqk,bhkd->bhgqd", p, v) / _safe(l)
    return out.reshape(b, hq, c, d).to(q.dtype)


def paged_decode_attention_quant_torch(q, k_q, k_scale, v_q, v_scale, block_tables,
                                       context_lens, *, bits: int = 8,
                                       scale: Optional[float] = None,
                                       block_pages: Optional[int] = None) -> torch.Tensor:
    """paged_decode_attention_torch over an intN pool: k_q/v_q (num_pages,
    Hkv, ps, Dq) int8 with Dq = D (int8) or D / 2 (int4 split-half),
    k_scale/v_scale (num_pages, Hkv) f32. Dequantizes the whole pool, then
    runs the f32 path: the same semantics as the kernel, O(pool) memory."""
    return paged_decode_attention_torch(
        q, dequantize_pages(k_q, k_scale, bits=bits), dequantize_pages(v_q, v_scale, bits=bits),
        block_tables, context_lens, scale=scale, block_pages=block_pages,
    )


def paged_prefill_chunk_quant_torch(q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale,
                                    block_tables, cursors, *, bits: int = 8,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """paged_prefill_chunk_torch over an intN pool: the past dequantizes,
    the present (the chunk's own K/V) stays in the compute dtype."""
    return paged_prefill_chunk_torch(
        q, chunk_k, chunk_v, dequantize_pages(k_q, k_scale, bits=bits),
        dequantize_pages(v_q, v_scale, bits=bits), block_tables, cursors, scale=scale,
    )


# ---------------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------------
_lib_handle: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    """The built kernel library (nvcc runs here on first use), with every C
    entry's argument types declared."""
    global _lib_handle
    if _lib_handle is None:
        from . import _build

        lib = _build.load("paged_attention")
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.repro_paged_decode.argtypes = [i, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p]
        lib.repro_paged_decode.restype = i
        lib.repro_paged_prefill_chunk.argtypes = [
            i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p,
        ]
        lib.repro_paged_prefill_chunk.restype = i
        lib.repro_paged_decode_quant.argtypes = [
            i, i, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, f, p,
        ]
        lib.repro_paged_decode_quant.restype = i
        lib.repro_paged_prefill_chunk_quant.argtypes = [
            i, i, p, p, p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, f, p,
        ]
        lib.repro_paged_prefill_chunk_quant.restype = i
        lib.repro_cuda_error_string.argtypes = [i]
        lib.repro_cuda_error_string.restype = ctypes.c_char_p
        _lib_handle = lib
    return _lib_handle


def _raise_on(rc: int, what: str) -> None:
    if rc != 0:
        msg = _lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")


def _check(name: str, t: torch.Tensor, *, ndim: int, dtype=None, device=None) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if device is not None and t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape {tuple(t.shape)}")
    if dtype is not None and t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_attention_operands(q, k_pool, v_pool, block_tables, lens, lens_name,
                              bits: Optional[int] = None):
    """Validate the operands a paged kernel reads; ``bits`` set means the
    pools are intN bytes (int8, last dim D or D / 2 for int4)."""
    _check("q", q, ndim=4)
    dev = q.device
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    pool_dtype = q.dtype if bits is None else torch.int8
    for name, t in (("k_pool", k_pool), ("v_pool", v_pool)):
        _check(name, t, ndim=4, dtype=pool_dtype, device=dev)
    if k_pool.shape != v_pool.shape:
        raise ValueError(f"k_pool {tuple(k_pool.shape)} != v_pool {tuple(v_pool.shape)}")
    _check("block_tables", block_tables, ndim=2, dtype=torch.int32, device=dev)
    _check(lens_name, lens, ndim=1, dtype=torch.int32, device=dev)
    b, hq, _, d = q.shape
    _, hkv, _, dk = k_pool.shape
    if bits == 4:
        dk *= 2
    if d not in HEAD_DIMS or dk != d:
        raise ValueError(f"head dim {d} (pool {dk}) not supported: kernels take {HEAD_DIMS}")
    if hq % hkv:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {hkv}")
    if block_tables.shape[0] != b or lens.shape[0] != b:
        raise ValueError(
            f"batch {b}: block_tables {tuple(block_tables.shape)}, {lens_name} {tuple(lens.shape)}"
        )


def paged_flash_decode(
    q: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    context_lens: torch.Tensor,
    *,
    scale: Optional[float] = None,
    block_pages: int = 1,
) -> torch.Tensor:
    """One-token GQA decode against a paged pool (kernel: paged_decode_kernel).

    Shapes as paged_decode_attention_torch; on CUDA the operands must be
    contiguous, q and pools one of float32/bfloat16, tables/lengths int32, and
    D in HEAD_DIMS. ``block_pages`` must divide max_pages (as in the reference;
    ops.effective_block_pages picks a divisor); the kernel does not use it and
    the result does not depend on it. Output in q's dtype."""
    bp = max(1, int(block_pages))
    if block_tables.shape[1] % bp:
        raise ValueError(
            f"block_pages {bp} must divide max_pages {block_tables.shape[1]} "
            "(ops.effective_block_pages picks a valid divisor)"
        )
    if q.device.type == "cpu":
        return paged_decode_attention_torch(
            q, k_pool, v_pool, block_tables, context_lens, scale=scale
        )
    _check_attention_operands(q, k_pool, v_pool, block_tables, context_lens, "context_lens")
    b, hq, tq, d = q.shape
    num_pages, hkv, ps, _ = k_pool.shape
    if tq != 1:
        raise ValueError(f"decode wants one query token, got q {tuple(q.shape)}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    rc = _lib().repro_paged_decode(
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(),
        b, hq, hkv, d, ps, num_pages, block_tables.shape[1], scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, "paged_decode")
    paged_flash_decode.launches += 1
    return out


paged_flash_decode.launches = 0


def paged_flash_prefill_chunk(
    q: torch.Tensor,
    chunk_k: torch.Tensor,
    chunk_v: torch.Tensor,
    k_pool: torch.Tensor,
    v_pool: torch.Tensor,
    block_tables: torch.Tensor,
    cursors: torch.Tensor,
    *,
    scale: Optional[float] = None,
) -> torch.Tensor:
    """Chunked-prefill GQA attention, past from the pool and present from the
    chunk's own K/V (kernel: paged_chunk_kernel). Shapes as
    paged_prefill_chunk_torch; C need not be a power of two nor a page
    multiple. On CUDA, chunk_k/chunk_v share q's dtype and everything is
    contiguous. Rows past a row's valid length come out as garbage the caller
    discards; nothing outside the tensors is read or written."""
    if q.device.type == "cpu":
        return paged_prefill_chunk_torch(
            q, chunk_k, chunk_v, k_pool, v_pool, block_tables, cursors, scale=scale
        )
    _check_attention_operands(q, k_pool, v_pool, block_tables, cursors, "cursors")
    b, hq, c, d = q.shape
    num_pages, hkv, ps, _ = k_pool.shape
    for name, t in (("chunk_k", chunk_k), ("chunk_v", chunk_v)):
        _check(name, t, ndim=4, dtype=q.dtype, device=q.device)
        if tuple(t.shape) != (b, hkv, c, d):
            raise ValueError(f"{name} must be {(b, hkv, c, d)}, got {tuple(t.shape)}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    rc = _lib().repro_paged_prefill_chunk(
        _DTYPE_CODE[q.dtype], q.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(), cursors.data_ptr(),
        out.data_ptr(), b, hq, hkv, c, d, ps, num_pages, block_tables.shape[1], scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, "paged_prefill_chunk")
    paged_flash_prefill_chunk.launches += 1
    return out


paged_flash_prefill_chunk.launches = 0


def _check_scales(k_q, k_scale, v_scale, bits: int) -> None:
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    for name, t in (("k_scale", k_scale), ("v_scale", v_scale)):
        _check(name, t, ndim=2, dtype=torch.float32, device=k_q.device)
        if tuple(t.shape) != tuple(k_q.shape[:2]):
            raise ValueError(f"{name} must be {tuple(k_q.shape[:2])}, got {tuple(t.shape)}")


def paged_flash_decode_quant(q, k_q, k_scale, v_q, v_scale, block_tables, context_lens, *,
                             bits: int = 8, scale: Optional[float] = None,
                             block_pages: int = 1) -> torch.Tensor:
    """One-token GQA decode against an intN paged pool (kernel:
    paged_decode_kernel over a QuantPool, dequantizing each staged page as
    float(q) * scale). Shapes as paged_decode_attention_quant_torch; on CUDA
    q is float32/bfloat16, pools int8, scales float32, all contiguous.
    ``block_pages`` as in paged_flash_decode."""
    bp = max(1, int(block_pages))
    if block_tables.shape[1] % bp:
        raise ValueError(
            f"block_pages {bp} must divide max_pages {block_tables.shape[1]} "
            "(ops.effective_block_pages picks a valid divisor)"
        )
    if q.device.type == "cpu":
        return paged_decode_attention_quant_torch(
            q, k_q, k_scale, v_q, v_scale, block_tables, context_lens, bits=bits, scale=scale,
        )
    _check_attention_operands(q, k_q, v_q, block_tables, context_lens, "context_lens", bits)
    _check_scales(k_q, k_scale, v_scale, bits)
    b, hq, tq, d = q.shape
    num_pages, hkv, ps, _ = k_q.shape
    if tq != 1:
        raise ValueError(f"decode wants one query token, got q {tuple(q.shape)}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    rc = _lib().repro_paged_decode_quant(
        _DTYPE_CODE[q.dtype], bits, q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
        v_q.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), b, hq, hkv, d, ps, num_pages, block_tables.shape[1], scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, "paged_decode_quant")
    paged_flash_decode_quant.launches += 1
    return out


paged_flash_decode_quant.launches = 0


def paged_flash_prefill_chunk_quant(q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale,
                                    block_tables, cursors, *, bits: int = 8,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill GQA attention with the past read from an intN pool
    and dequantized per staged page; the present (chunk_k/chunk_v, q's dtype)
    is never read through the pool (kernel: paged_chunk_kernel over a
    QuantPool). Shapes as paged_prefill_chunk_quant_torch."""
    if q.device.type == "cpu":
        return paged_prefill_chunk_quant_torch(
            q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale, block_tables, cursors,
            bits=bits, scale=scale,
        )
    _check_attention_operands(q, k_q, v_q, block_tables, cursors, "cursors", bits)
    _check_scales(k_q, k_scale, v_scale, bits)
    b, hq, c, d = q.shape
    num_pages, hkv, ps, _ = k_q.shape
    for name, t in (("chunk_k", chunk_k), ("chunk_v", chunk_v)):
        _check(name, t, ndim=4, dtype=q.dtype, device=q.device)
        if tuple(t.shape) != (b, hkv, c, d):
            raise ValueError(f"{name} must be {(b, hkv, c, d)}, got {tuple(t.shape)}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    rc = _lib().repro_paged_prefill_chunk_quant(
        _DTYPE_CODE[q.dtype], bits, q.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(),
        k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
        block_tables.data_ptr(), cursors.data_ptr(), out.data_ptr(),
        b, hq, hkv, c, d, ps, num_pages, block_tables.shape[1], scale,
        torch.cuda.current_stream(q.device).cuda_stream,
    )
    _raise_on(rc, "paged_prefill_chunk_quant")
    paged_flash_prefill_chunk_quant.launches += 1
    return out


paged_flash_prefill_chunk_quant.launches = 0

KERNEL_WRAPPERS = {
    "paged_decode": paged_flash_decode,
    "paged_prefill_chunk": paged_flash_prefill_chunk,
    "paged_decode_quant": paged_flash_decode_quant,
    "paged_prefill_chunk_quant": paged_flash_prefill_chunk_quant,
}
