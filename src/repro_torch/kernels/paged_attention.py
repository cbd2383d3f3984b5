"""Paged GQA attention over a block-table KV pool: plain PyTorch versions and
the wrappers that launch the hand-written CUDA kernels.

The KV cache is a pool of fixed-size pages, (num_pages, Hkv, page_size, D);
row b of ``block_tables`` maps sequence b's logical page j to a physical page
(entries past the sequence's allocation point at the reserved null page 0).
This is the port of ``repro.kernels.paged_attention``:

  paged_decode_attention_torch   <- paged_decode_attention_jnp (unblocked and
                                    blocked forms)
  split_partials_torch,          the decode kernels' split-K: per-split
  paged_decode_partials_torch,   partials (any keys; over the pages), their
  combine_splits_torch,          log-sum-exp merge and the split count
  plan_decode_splits             (plain; no reference namesake)
  paged_prefill_chunk_torch      <- paged_prefill_chunk_jnp
  paged_prefill_chunk_tiled_torch  the bf16 chunk body's tiles, runs and
                                    scale folding, in plain f32, and
  plan_chunk_splits                 its runs (no reference namesakes)
  paged_flash_decode             <- paged_flash_decode (Pallas) — launches
                                    csrc/decode_splitk.cuh::split_decode_kernel
                                    over the pages, then the combine
  paged_flash_prefill_chunk      <- paged_flash_prefill_chunk (Pallas) —
                                    launches paged_chunk_mma_kernel (bf16,
                                    tensor cores) or paged_chunk_kernel (f32)

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

from repro_torch.core.distributed import (  # noqa: F401  (re-exported: the reference's names)
    pack_int4_splithalf,
    unpack_int4_splithalf,
)

from . import _build
from .common import no_grad_through

NEG_INF = -1e30
# csrc/paged_attention.cu's kGeometry for the bf16 chunk body, in its order
# (query rows a block, keys a tile at each head dim, the most runs a launch
# takes); the library is checked against it when it loads
GEOMETRY = {"chunk_rows": 64, "chunk_keys_d16": 64, "chunk_keys_d32": 64, "chunk_keys_d64": 64,
            "chunk_keys_d112": 64, "chunk_keys_d128": 64, "chunk_keys_d256": 32,
            "chunk_max_splits": 64}
MAX_CHUNK_SPLITS = GEOMETRY["chunk_max_splits"]
HEAD_DIMS = (16, 32, 64, 112, 128, 256)
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


# ---------------------------------------------------------------------------------
# page dequantization (the split-half int4 packers live in core.distributed)
# ---------------------------------------------------------------------------------
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


def plan_decode_splits(max_pages: int, batch: int, hkv: int, page_size: int, head_dim: int,
                       sm_count: int):
    """(splits, pages_per_split) of the split-K decode kernel: the keys of
    each (sequence, KV head) are cut into runs of whole tiles (~64 tokens,
    ~32 at D 128 and 256, never less than one page), enough runs for two
    blocks a SM where the table has that many tiles, and no run past the
    table. A dense cache of S slots is planned as S pages of one slot.
    Depends only on shapes and the SM count, never on the lengths or the
    position."""
    tile = max(1, (64 if head_dim <= 64 else 32) // page_size)
    max_splits = -(-max_pages // tile)
    want = -(-2 * sm_count // max(1, batch * hkv))
    splits = max(1, min(want, max_splits))
    pages_per_split = -(-(-(-max_pages // splits)) // tile) * tile
    return -(-max_pages // pages_per_split), pages_per_split


def split_partials_torch(q, k, v, live, *, keys_per_split: int, scale: float):
    """The split-K decode's partials over gathered keys: q (B, Hq, 1, D), k /
    v (B, Hkv, S, D), live (B, S) bool; keys [s * K, (s + 1) * K) (K =
    ``keys_per_split``) give split s its running max m, sum l and
    unnormalized accumulator acc, f32. Returns m, l (B, Hq, splits) and acc
    (B, Hq, splits, D); a split with no live key has l = 0, m = -inf and acc
    = 0. The paged and the dense decode kernels leave the same three in
    their workspace."""
    b, hq, _, d = q.shape
    _, hkv, s_len, _ = k.shape
    group = hq // hkv
    splits = -(-s_len // keys_per_split)
    pad = splits * keys_per_split - s_len
    k = torch.nn.functional.pad(k.float(), (0, 0, 0, pad)).reshape(b, hkv, splits,
                                                                  keys_per_split, d)
    v = torch.nn.functional.pad(v.float(), (0, 0, 0, pad)).reshape(b, hkv, splits,
                                                                  keys_per_split, d)
    live = torch.nn.functional.pad(live, (0, pad)).reshape(b, 1, 1, splits, keys_per_split)
    qg = q.reshape(b, hkv, group, d).float()
    s = torch.einsum("bhgd,bhskd->bhgsk", qg, k) * scale
    s = torch.where(live, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * live
    l = p.sum(dim=-1)
    acc = torch.einsum("bhgsk,bhskd->bhgsd", p, v)
    m = torch.where(l > 0, m, torch.full_like(m, -math.inf))
    return m.reshape(b, hq, splits), l.reshape(b, hq, splits), acc.reshape(b, hq, splits, d)


def paged_decode_partials_torch(q, k_pool, v_pool, block_tables, context_lens, *,
                                pages_per_split: int, scale: Optional[float] = None):
    """The paged decode's partials: logical pages [s * P, (s + 1) * P) of
    each row's table (P = ``pages_per_split``) are split s
    (split_partials_torch over the gathered pages, keys live below the
    row's length)."""
    d = q.shape[-1]
    ps = k_pool.shape[2]
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    cap = block_tables.shape[1] * ps
    live = (torch.arange(cap, device=q.device)[None, :]
            < torch.clamp(context_lens, max=cap)[:, None])
    return split_partials_torch(q, _gather_pages(k_pool, block_tables),
                                _gather_pages(v_pool, block_tables), live,
                                keys_per_split=pages_per_split * ps, scale=scale)


def combine_splits_torch(m: torch.Tensor, l: torch.Tensor, acc: torch.Tensor) -> torch.Tensor:
    """The log-sum-exp merge of split partials m, l (..., S) and acc (..., S,
    D): m* = max of m over live splits (l > 0), l* = sum l e^(m - m*), out =
    sum acc e^(m - m*) / l*, and 0 where l* is 0. A dead split's m and acc are
    never used. Returns f32 (..., D)."""
    live = l > 0
    m_star = torch.where(live, m, torch.full_like(m, -math.inf)).amax(dim=-1, keepdim=True)
    w = torch.where(live, torch.exp(m - m_star), torch.zeros_like(m))
    l_star = (w * l).sum(dim=-1)
    o = torch.where(live[..., None], w[..., None] * acc, torch.zeros_like(acc)).sum(dim=-2)
    return o / torch.where(l_star > 0, l_star, torch.ones_like(l_star))[..., None]


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


def chunk_tile_keys(head_dim: int) -> int:
    """Keys a tile of the bf16 chunk body (paged_chunk_mma_kernel) holds."""
    return GEOMETRY[f"chunk_keys_d{head_dim}"]


def _online_softmax(qr, tiles, scale):
    """(m, l, acc) of rows ``qr`` (Hkv, R, D) over ``tiles`` in order, each
    (k, v (Hkv, n, D), column scales of K and V (Hkv, n), liveness
    broadcastable to (Hkv, R, n)): S's columns take K's scale, P's columns
    V's scale after l took P."""
    hkv, r, d = qr.shape
    m = torch.full((hkv, r, 1), NEG_INF, device=qr.device)
    l = torch.zeros((hkv, r, 1), device=qr.device)
    acc = torch.zeros((hkv, r, d), device=qr.device)
    for k, v, cs_k, cs_v, live in tiles:
        s = torch.einsum("hrd,hkd->hrk", qr, k) * scale * cs_k[:, None, :]
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new) * live
        alpha = torch.exp(m - m_new)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = alpha * acc + torch.einsum("hrk,hkd->hrd", p * cs_v[:, None, :], v)
        m = m_new
    return m[..., 0], l[..., 0], acc


def paged_prefill_chunk_tiled_torch(q, chunk_k, chunk_v, k_pool, v_pool, block_tables, cursors,
                                    *, k_scale=None, v_scale=None, bits: Optional[int] = None,
                                    scale: Optional[float] = None, tile: Optional[int] = None,
                                    splits: int = 1) -> torch.Tensor:
    """The bf16 chunk body's arithmetic in plain f32, block by block as the
    kernel runs: the query rows of each KV head t-major (row = t * G + g) in
    blocks of GEOMETRY["chunk_rows"]; a block's keys in tiles of ``tile``
    (chunk_tile_keys(D) by default), first the past's ceil(past_len / tile)
    (logical positions below past_len = min(cursor, max_pages * page_size),
    a tile spanning pages as it may), then the chunk's own up to the block's
    last query position, causal; an online softmax (m, l, acc) across the
    tiles. Over an intN pool (``bits`` set, with k_scale / v_scale) the pages
    stay integers: each key's (page, head) scale multiplies its column of S
    for K, and its column of P for V (after l took P), as the kernel folds
    them; the present has scale 1. With ``splits`` > 1 a block's n tiles are
    cut into the kernel's runs (run s takes tiles [n s / S, n (s + 1) / S)),
    each run's partial is kept apart and the partials are merged by
    combine_splits_torch. A row with l == 0 outputs 0. Shapes as
    paged_prefill_chunk_torch; returns q's dtype."""
    b, hq, c, d = q.shape
    num_pages, hkv, ps, _ = k_pool.shape
    group = hq // hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    tile = tile or chunk_tile_keys(d)
    rows_a_block = GEOMETRY["chunk_rows"]
    dev = q.device
    if bits == 4:
        k_pool, v_pool = unpack_int4_splithalf(k_pool), unpack_int4_splithalf(v_pool)
    pages = block_tables.long().clamp(0, num_pages - 1)
    k_past = _gather_pages(k_pool, pages).float()  # (B, Hkv, cap, D) integers or values
    v_past = _gather_pages(v_pool, pages).float()
    cap = k_past.shape[2]
    if bits is not None:  # (B, Hkv, cap): each key's page scale
        sk = k_scale[pages].movedim(2, 1).repeat_interleave(ps, dim=2).float()
        sv = v_scale[pages].movedim(2, 1).repeat_interleave(ps, dim=2).float()
    else:
        sk = sv = torch.ones((b, hkv, cap), device=dev)
    past_len = cursors.long().clamp(0, cap).tolist()
    # (B, Hkv, C * G, D): row t * G + g is query t of head h * G + g
    qr = q.float().reshape(b, hkv, group, c, d).transpose(2, 3).reshape(b, hkv, c * group, d)
    out = torch.empty_like(qr)
    for i in range(b):
        past = []  # the past's tiles: every block of this sequence has the same
        for j0 in range(0, past_len[i], tile):
            j = torch.arange(j0, min(j0 + tile, cap), device=dev)
            past.append((k_past[i][:, j], v_past[i][:, j], sk[i][:, j], sv[i][:, j],
                         (j < past_len[i])[None, None, :]))
        for row0 in range(0, c * group, rows_a_block):
            rows = torch.arange(row0, min(row0 + rows_a_block, c * group), device=dev)
            t_row = rows // group
            tiles = list(past)
            for t0 in range(0, int(t_row[-1]) + 1, tile):  # the present, to the last row's t
                tk = torch.arange(t0, min(t0 + tile, c), device=dev)
                ones = torch.ones((hkv, tk.numel()), device=dev)
                tiles.append((chunk_k[i][:, tk].float(), chunk_v[i][:, tk].float(), ones, ones,
                              (tk[None, :] <= t_row[:, None])[None]))
            n = len(tiles)
            parts = [_online_softmax(qr[i][:, rows], tiles[n * sp // splits:n * (sp + 1) // splits],
                                     scale) for sp in range(splits)]
            if splits == 1:
                m, l, acc = parts[0]
                out[i][:, rows] = acc / _safe(l)[..., None]
            else:
                m, l, acc = (torch.stack(x, dim=-1 if j < 2 else -2)
                             for j, x in enumerate(zip(*parts)))
                out[i][:, rows] = combine_splits_torch(m, l, acc)
    return out.reshape(b, hkv, c, group, d).transpose(2, 3).reshape(b, hq, c, d).to(q.dtype)


def plan_chunk_splits(batch: int, hq: int, hkv: int, chunk: int, head_dim: int, max_pages: int,
                      page_size: int, dtype: torch.dtype, sm_count: int) -> int:
    """The runs the bf16 chunk body cuts each block's key tiles into: enough
    blocks for about one and a half a SM where the 64-row blocks are fewer
    (each run adds its partial's writes and the combine's reads, so more
    runs cost more than they hide), at most one run a tile of the longest
    possible past plus the chunk and MAX_CHUNK_SPLITS;
    1 for float32 (one run, no combine) and where the combine's grid would
    not take the B * Hq * C rows. Depends only on shapes and the SM count,
    never on the cursors (they stay on the device)."""
    if dtype != torch.bfloat16 or batch * hq * chunk > 65535:
        return 1
    blocks = -(-chunk * (hq // hkv) // GEOMETRY["chunk_rows"]) * hkv * batch
    nk = chunk_tile_keys(head_dim)
    tiles = -(-max_pages * page_size // nk) + -(-chunk // nk)
    return max(1, min(-(-3 * sm_count // (2 * blocks)), tiles, MAX_CHUNK_SPLITS))


# ---------------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------------
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = _build.Binding("paged_attention", {
    "repro_paged_decode": [_i, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                           _f, _p],
    "repro_paged_prefill_chunk": [
        _i, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p, _i, _p,
    ],
    "repro_paged_decode_quant": [
        _i, _i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p,
    ],
    "repro_paged_prefill_chunk_quant": [
        _i, _i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p,
        _i, _p,
    ],
}, geometry=GEOMETRY)


_SM_COUNT = {}


def sm_count(device: torch.device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SM_COUNT:
        _SM_COUNT[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SM_COUNT[idx]


def _decode_split(q, hkv: int, ps: int, max_pages: int):
    """(splits, pages_per_split, workspace) for one decode launch (a dense
    cache passes ps 1 and max_pages S): the plan for these shapes and f32 room
    for the partials (m, l, acc) of every query row and split, from
    PyTorch's caching allocator on q's stream."""
    b, hq, _, d = q.shape
    splits, pps = plan_decode_splits(max_pages, b, hkv, ps, d, sm_count(q.device))
    ws = torch.empty(b * hq * splits * (d + 2), dtype=torch.float32, device=q.device)
    return splits, pps, ws


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


def _chunk_split(q, hkv: int, ps: int, max_pages: int):
    """(splits, workspace) for one chunk launch: plan_chunk_splits for these
    shapes and, with more than one run, f32 room for every run's partial (m,
    l, acc) of every query row."""
    b, hq, c, d = q.shape
    splits = plan_chunk_splits(b, hq, hkv, c, d, max_pages, ps, q.dtype, sm_count(q.device))
    if splits == 1:
        return 1, None
    return splits, torch.empty(b * hq * c * splits * (d + 2), dtype=torch.float32,
                               device=q.device)


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
    """One-token GQA decode against a paged pool (kernel: split_decode_kernel
    over PagedKeys, split-K over the pages as plan_decode_splits picks, then
    the combine).

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
    no_grad_through("paged_decode", q, k_pool, v_pool)
    _check_attention_operands(q, k_pool, v_pool, block_tables, context_lens, "context_lens")
    b, hq, tq, d = q.shape
    num_pages, hkv, ps, _ = k_pool.shape
    if tq != 1:
        raise ValueError(f"decode wants one query token, got q {tuple(q.shape)}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    max_pages = block_tables.shape[1]
    splits, pps, ws = _decode_split(q, hkv, ps, max_pages)
    _LIB.launch(
        "repro_paged_decode", "paged_decode",
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), context_lens.data_ptr(), out.data_ptr(), ws.data_ptr(),
        b, hq, hkv, d, ps, num_pages, max_pages, splits, pps, scale,
        device=q.device,
    )
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
    chunk's own K/V (kernel: paged_chunk_mma_kernel on the tensor cores for
    bfloat16, its key tiles cut into plan_chunk_splits runs merged by
    common.cuh's combine where the 64-row blocks are few; paged_chunk_kernel's
    f32 CUDA-core products for float32; operands off 16 bytes are staged with
    plain loads). Shapes as
    paged_prefill_chunk_torch; C need not be a power of two nor a page
    multiple. On CUDA, chunk_k/chunk_v share q's dtype and everything is
    contiguous. Rows past a row's valid length come out as garbage the caller
    discards; nothing outside the tensors is read or written."""
    if q.device.type == "cpu":
        return paged_prefill_chunk_torch(
            q, chunk_k, chunk_v, k_pool, v_pool, block_tables, cursors, scale=scale
        )
    no_grad_through("paged_prefill_chunk", q, chunk_k, chunk_v, k_pool, v_pool)
    _check_attention_operands(q, k_pool, v_pool, block_tables, cursors, "cursors")
    b, hq, c, d = q.shape
    num_pages, hkv, ps, _ = k_pool.shape
    for name, t in (("chunk_k", chunk_k), ("chunk_v", chunk_v)):
        _check(name, t, ndim=4, dtype=q.dtype, device=q.device)
        if tuple(t.shape) != (b, hkv, c, d):
            raise ValueError(f"{name} must be {(b, hkv, c, d)}, got {tuple(t.shape)}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    splits, ws = _chunk_split(q, hkv, ps, block_tables.shape[1])
    _LIB.launch(
        "repro_paged_prefill_chunk", "paged_prefill_chunk",
        _DTYPE_CODE[q.dtype], q.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(),
        k_pool.data_ptr(), v_pool.data_ptr(), block_tables.data_ptr(), cursors.data_ptr(),
        out.data_ptr(), b, hq, hkv, c, d, ps, num_pages, block_tables.shape[1], scale,
        ws.data_ptr() if ws is not None else None, splits, device=q.device,
    )
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
    split_decode_kernel over a QuantPool, split-K as paged_flash_decode,
    dequantizing 8 features of a page row at a time as float(q) * scale).
    Shapes as paged_decode_attention_quant_torch; on CUDA q is
    float32/bfloat16, pools int8, scales float32, all contiguous.
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
    no_grad_through("paged_decode_quant", q, k_scale, v_scale)
    _check_attention_operands(q, k_q, v_q, block_tables, context_lens, "context_lens", bits)
    _check_scales(k_q, k_scale, v_scale, bits)
    b, hq, tq, d = q.shape
    num_pages, hkv, ps, _ = k_q.shape
    if tq != 1:
        raise ValueError(f"decode wants one query token, got q {tuple(q.shape)}")
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    max_pages = block_tables.shape[1]
    splits, pps, ws = _decode_split(q, hkv, ps, max_pages)
    _LIB.launch(
        "repro_paged_decode_quant", "paged_decode_quant",
        _DTYPE_CODE[q.dtype], bits, q.data_ptr(), k_q.data_ptr(), k_scale.data_ptr(),
        v_q.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(), context_lens.data_ptr(),
        out.data_ptr(), ws.data_ptr(), b, hq, hkv, d, ps, num_pages, max_pages, splits, pps,
        scale, device=q.device,
    )
    paged_flash_decode_quant.launches += 1
    return out


paged_flash_decode_quant.launches = 0


def paged_flash_prefill_chunk_quant(q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale,
                                    block_tables, cursors, *, bits: int = 8,
                                    scale: Optional[float] = None) -> torch.Tensor:
    """Chunked-prefill GQA attention with the past read from an intN pool
    and dequantized per staged page; the present (chunk_k/chunk_v, q's dtype)
    is never read through the pool (kernel: paged_chunk_mma_kernel over a
    QuantPool for bfloat16: the bytes staged as bf16 integers, each key's
    (page, head) scale on its column of S and of P; paged_chunk_kernel for
    float32). Shapes as paged_prefill_chunk_quant_torch."""
    if q.device.type == "cpu":
        return paged_prefill_chunk_quant_torch(
            q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale, block_tables, cursors,
            bits=bits, scale=scale,
        )
    no_grad_through("paged_prefill_chunk_quant", q, chunk_k, chunk_v, k_scale, v_scale)
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
    splits, ws = _chunk_split(q, hkv, ps, block_tables.shape[1])
    _LIB.launch(
        "repro_paged_prefill_chunk_quant", "paged_prefill_chunk_quant",
        _DTYPE_CODE[q.dtype], bits, q.data_ptr(), chunk_k.data_ptr(), chunk_v.data_ptr(),
        k_q.data_ptr(), k_scale.data_ptr(), v_q.data_ptr(), v_scale.data_ptr(),
        block_tables.data_ptr(), cursors.data_ptr(), out.data_ptr(),
        b, hq, hkv, c, d, ps, num_pages, block_tables.shape[1], scale,
        ws.data_ptr() if ws is not None else None, splits, device=q.device,
    )
    paged_flash_prefill_chunk_quant.launches += 1
    return out


paged_flash_prefill_chunk_quant.launches = 0

KERNEL_WRAPPERS = {
    "paged_decode": paged_flash_decode,
    "paged_prefill_chunk": paged_flash_prefill_chunk,
    "paged_decode_quant": paged_flash_decode_quant,
    "paged_prefill_chunk_quant": paged_flash_prefill_chunk_quant,
}
