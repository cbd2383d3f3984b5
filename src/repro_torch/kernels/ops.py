"""ops — the public kernel API of the port, with impl dispatch.

Port of ``repro.kernels.ops`` for the serving path. ``impl`` replaces the
reference's ``_want_pallas``:

  "cuda"   the hand-written kernel; raises unless the operands are CUDA tensors
  "torch"  the plain PyTorch version
  "auto"   the kernel for CUDA tensors, the plain version for CPU tensors

``attention`` (monolithic prefill) and ``sample_tokens`` are plain PyTorch in
the reference too (jnp, not Pallas), so they have no kernel here either.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .paged_attention import (
    NEG_INF,
    paged_decode_attention_torch,
    paged_flash_decode,
    paged_flash_prefill_chunk,
    paged_prefill_chunk_torch,
)

IMPLS = ("auto", "cuda", "torch")


def _want_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl == "torch":
        return False
    if impl == "cuda":
        if x.device.type != "cuda":
            raise ValueError(f"impl='cuda' needs CUDA tensors, got {x.device}")
        return True
    if impl == "auto":
        return x.device.type == "cuda"
    raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")


# ---------------------------------------------------------------------------------
# attention (monolithic prefill)
# ---------------------------------------------------------------------------------
def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, scale: Optional[float] = None,
              block_k: int = 512) -> torch.Tensor:
    """Blocked online-softmax GQA attention, the semantics of the reference's
    ``attention_jnp``: q (B, Hq, Tq, D), k/v (B, Hkv, Tk, D), query row i at
    absolute position i + q_offset, optional causal mask and local window,
    f32 sums, fully masked rows output 0. Memory O(Tq * block_k)."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    qf = q.float() * scale
    q_pos = torch.arange(tq, device=q.device)[:, None] + q_offset
    m = torch.full((b, hq, tq, 1), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, hq, tq, 1), dtype=torch.float32, device=q.device)
    acc = torch.zeros((b, hq, tq, d), dtype=torch.float32, device=q.device)
    for k0 in range(0, tk, block_k):
        kb = k[:, :, k0:k0 + block_k].float().repeat_interleave(group, dim=1)
        vb = v[:, :, k0:k0 + block_k].float().repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kb)
        k_pos = k0 + torch.arange(kb.shape[2], device=q.device)[None, :]
        live = torch.ones((tq, kb.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            live = live & (k_pos <= q_pos)
        if window is not None:
            live = live & (k_pos > q_pos - window)
        s = torch.where(live, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        p = torch.exp(s - m_new)
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    return (acc / torch.where(l == 0, torch.ones_like(l), l)).to(q.dtype)


# ---------------------------------------------------------------------------------
# paged attention (the serving path's two kernels)
# ---------------------------------------------------------------------------------
def effective_block_pages(block_pages, max_pages: int) -> int:
    """Sanitize the decode block-shape knob against a table width: the largest
    divisor of ``max_pages`` that is <= ``block_pages``, or 1 when the knob is
    unset (None/0)."""
    if not block_pages or max_pages <= 0:
        return 1
    bp = min(int(block_pages), max_pages)
    while max_pages % bp:
        bp -= 1
    return bp


def paged_decode_attention(q, k_pool, v_pool, block_tables, context_lens, *,
                           scale=None, block_pages=None, impl: str = "auto"):
    """One-token GQA decode against a paged pool (num_pages, Hkv, ps, D);
    block_tables (B, max_pages) int32; context_lens (B,) int32. ``block_pages``
    is sanitized through effective_block_pages, so callers pass a tuned value
    verbatim."""
    bp = effective_block_pages(block_pages, block_tables.shape[1])
    if _want_kernel(impl, q):
        return paged_flash_decode(
            q, k_pool, v_pool, block_tables, context_lens, scale=scale, block_pages=bp,
        )
    return paged_decode_attention_torch(
        q, k_pool, v_pool, block_tables, context_lens, scale=scale,
        block_pages=bp if bp > 1 else None,
    )


def paged_prefill_chunk_attention(q, chunk_k, chunk_v, k_pool, v_pool, block_tables,
                                  cursors, *, scale=None, impl: str = "auto"):
    """Chunked-prefill GQA attention: a query chunk (B, Hq, C, D) against the
    resident past (pool positions < cursors[b], read through the table) plus
    its own present (chunk_k/chunk_v (B, Hkv, C, D), causal) in one softmax."""
    if _want_kernel(impl, q):
        return paged_flash_prefill_chunk(
            q, chunk_k, chunk_v, k_pool, v_pool, block_tables, cursors, scale=scale,
        )
    return paged_prefill_chunk_torch(
        q, chunk_k, chunk_v, k_pool, v_pool, block_tables, cursors, scale=scale,
    )


# ---------------------------------------------------------------------------------
# on-device token sampling
# ---------------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def _mul32(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for uint32 values held in int64, without ever
    overflowing int64 (the product is split at 16 bits)."""
    lo = (h & 0xFFFF) * c
    hi = (((h >> 16) * c) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _fmix32(h: torch.Tensor) -> torch.Tensor:
    """murmur3's 32-bit finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def gumbel_noise(seed: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) standard Gumbel noise that is a pure function of (seed[b],
    pos[b], column): a counter-based integer hash, identical on every device
    and independent of batch composition. seed holds uint32 stream ids (any
    integer dtype; reduced mod 2**32), pos absolute positions."""
    key = _fmix32((seed.long() & _M32) ^ _fmix32(_mul32(pos.long() & _M32, 0x9E3779B1)))
    col = torch.arange(n, device=seed.device, dtype=torch.int64)
    h = _fmix32(key[:, None] ^ _mul32(col[None, :] + 0x165667B1, 0x27D4EB2F))
    u = ((h >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))  # in (0, 1)
    return -torch.log(-torch.log(u))


def _filter_topk_topp(x, temperature, top_k, top_p, *, vocab: int):
    """Temperature-scale + top-k/top-p filter a batch of masked logit rows
    (pad columns already -inf). Returns z = x / max(temperature, eps) with the
    filtered-out entries at -inf: top-k keeps the k largest (ties at the k-th
    value all kept), then top-p keeps the smallest head of the scaled
    distribution whose mass reaches top_p (the crossing token included)."""
    k_eff = torch.clamp(torch.where(top_k > 0, top_k, torch.full_like(top_k, vocab)), 1, vocab)
    x_desc = torch.sort(x, dim=-1, descending=True).values
    kth = torch.gather(x_desc, 1, (k_eff[:, None] - 1).long())
    xf = torch.where(x >= kth, x, torch.full_like(x, -math.inf))
    t = torch.clamp(temperature, min=1e-6)[:, None]
    z = xf / t
    p_eff = torch.where(top_p > 0, top_p, torch.ones_like(top_p))[:, None]
    z_desc = torch.sort(z, dim=-1, descending=True).values
    probs = torch.softmax(z_desc, dim=-1)
    cum = torch.cumsum(probs, dim=-1)
    keep = (cum - probs) < p_eff  # mass BEFORE the token; top-1 always kept
    cutoff = torch.where(keep, z_desc, torch.full_like(z_desc, math.inf)).amin(dim=-1, keepdim=True)
    return torch.where(z >= cutoff, z, torch.full_like(z, -math.inf))


def sample_tokens(logits, temperature, top_k, top_p, seed, pos, *, vocab: int,
                  sampled: Optional[bool] = None) -> torch.Tensor:
    """Batched token selection on the logits' device: greedy / temperature /
    top-k / top-p.

    logits (B, Vp) with Vp >= vocab (pad columns masked off); temperature (B,)
    f32, 0 = greedy argmax, bit-equal to argmax over ``logits[:, :vocab]``;
    top_k (B,) int (0 = off); top_p (B,) f32 (non-positive or 1 = off); seed
    (B,) uint32 stream ids (as int32/int64 bits); pos (B,) the absolute index
    of the token being sampled. Returns (B,) int32.

    Sampling is Gumbel-max over the filtered distribution with noise keyed
    only on (stream seed, position) (gumbel_noise), so a request re-samples
    the same token at a position after preemption-recompute or in another
    batch. The noise is not JAX's threefry stream: sampled tokens are
    reproducible within the port, not equal to the reference's.

    ``sampled`` is the caller's host-side knowledge of whether any row has
    temperature > 0 (None: read it from the device, one sync); False skips
    the sort/softmax work and costs one argmax."""
    vp = logits.shape[1]
    col = torch.arange(vp, device=logits.device)[None, :]
    x = torch.where(col < vocab, logits.float(), torch.full_like(logits, -math.inf, dtype=torch.float32))
    greedy = torch.argmax(x, dim=-1).to(torch.int32)
    if sampled is None:
        sampled = bool((temperature > 0).any())
    if not sampled:
        return greedy
    z = _filter_topk_topp(x, temperature, top_k, top_p, vocab=vocab)
    g = gumbel_noise(seed, pos, vp)
    tok = torch.argmax(z + g, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, tok, greedy)
