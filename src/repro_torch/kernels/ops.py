"""ops — the public kernel API of the port, with impl dispatch.

Port of ``repro.kernels.ops`` for the serving path. ``impl`` replaces the
reference's ``_want_pallas``:

  "cuda"   the hand-written kernel; raises unless the operands are CUDA tensors
  "torch"  the plain PyTorch version
  "auto"   the kernel for CUDA tensors, the plain version for CPU tensors

``attention`` (monolithic prefill) and ``sample_tokens`` are plain PyTorch in
the reference too (jnp, not Pallas), so they have no kernel here either; a
dense ``matmul`` is ``torch.matmul``, as the reference leaves it to XLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from .paged_attention import (
    NEG_INF,
    paged_decode_attention_quant_torch,
    paged_decode_attention_torch,
    paged_flash_decode,
    paged_flash_decode_quant,
    paged_flash_prefill_chunk,
    paged_flash_prefill_chunk_quant,
    paged_prefill_chunk_quant_torch,
    paged_prefill_chunk_torch,
)
from .quant_matmul import quant_matmul, quant_matmul_torch

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
# matmul with accessor dispatch
# ---------------------------------------------------------------------------------
def matmul(x: torch.Tensor, w, accessor=None, *, impl: str = "auto") -> torch.Tensor:
    """x: (..., K); w: a dense (K, N) tensor, or quantized buffers {"q",
    "scale"} stored output-major (N, K) with per-(row, K-block) scales, read
    through ``accessor`` (core.QuantizedAccessor: its ``bits``)."""
    if isinstance(w, dict):
        if accessor is None:
            raise ValueError("quantized weights need their accessor")
        lead = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1]).contiguous()
        if _want_kernel(impl, x2):
            y = quant_matmul(x2, w["q"], w["scale"], bits=accessor.bits)
        else:
            y = quant_matmul_torch(x2, w["q"], w["scale"], bits=accessor.bits)
        return y.reshape(*lead, y.shape[-1])
    return torch.matmul(x, w)


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
# paged attention (the serving path's kernels, over f32/bf16 or intN pools)
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


def paged_decode_attention_quant(q, k_q, k_scale, v_q, v_scale, block_tables, context_lens,
                                 *, bits: int = 8, scale=None, block_pages=None,
                                 impl: str = "auto"):
    """paged_decode_attention over a quantized pool: intN page bytes
    (num_pages, Hkv, ps, Dq) and per-(page, head) f32 scales (num_pages, Hkv),
    serving.engine.kvquant.PagedQuantSpec's encoding. Same table, length and
    ``block_pages`` contract as paged_decode_attention."""
    bp = effective_block_pages(block_pages, block_tables.shape[1])
    if _want_kernel(impl, q):
        return paged_flash_decode_quant(
            q, k_q, k_scale, v_q, v_scale, block_tables, context_lens,
            bits=bits, scale=scale, block_pages=bp,
        )
    return paged_decode_attention_quant_torch(
        q, k_q, k_scale, v_q, v_scale, block_tables, context_lens,
        bits=bits, scale=scale, block_pages=bp if bp > 1 else None,
    )


def paged_prefill_chunk_attention_quant(q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale,
                                        block_tables, cursors, *, bits: int = 8, scale=None,
                                        impl: str = "auto"):
    """paged_prefill_chunk_attention over a quantized pool: the past
    dequantizes, the present (the chunk's own K/V) stays in the compute dtype,
    so only attention across chunks pays the representation."""
    if _want_kernel(impl, q):
        return paged_flash_prefill_chunk_quant(
            q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale, block_tables, cursors,
            bits=bits, scale=scale,
        )
    return paged_prefill_chunk_quant_torch(
        q, chunk_k, chunk_v, k_q, k_scale, v_q, v_scale, block_tables, cursors,
        bits=bits, scale=scale,
    )


# ---------------------------------------------------------------------------------
# on-device token sampling
# ---------------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_THREEFRY_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k0, k1, x0, x1):
    """Threefry-2x32 (20 rounds) on int64 tensors holding uint32 values,
    broadcasting over all four operands — the block function behind JAX's
    default PRNG, ``threefry2x32_p``."""
    ks = (k0, k1, k0 ^ k1 ^ 0x1BD11BDA)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _THREEFRY_ROTATIONS[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = x0 ^ (((x1 << r) | (x1 >> (32 - r))) & _M32)
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def _fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """f32 fused multiply-add: a * b is exact in f64 (24 + 24 bits), and the
    sum is rounded to f64, then to f32."""
    b = b.double() if isinstance(b, torch.Tensor) else b
    c = c.double() if isinstance(c, torch.Tensor) else c
    return (a.double() * b + c).float()


# Cephes' logf polynomial, as f32 constants (exact as Python floats)
_LOG_P = [float(torch.tensor(p, dtype=torch.float32)) for p in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1)]
_LOG_Q1 = float(torch.tensor(-2.12194440e-4, dtype=torch.float32))
_LOG_Q2 = 0.693359375
_SQRTHF = float(torch.tensor(0.707106781186547524, dtype=torch.float32))


def _xla_log(x: torch.Tensor) -> torch.Tensor:
    """Natural log of positive normal f32 values, rounded as XLA's CPU backend
    rounds ``jnp.log``: Cephes' range reduction and polynomial with its
    multiply-adds fused. PyTorch's own log differs from it in the last bit on
    about a quarter of inputs, which would break bit-equality of the noise."""
    bits = x.view(torch.int32)
    e = ((bits >> 23) - 0x7F).float() + 1.0
    m = ((bits & ~0x7F800000) | 0x3F000000).view(torch.float32)  # mantissa in [0.5, 1)
    low = m < _SQRTHF
    e = e - low.float()
    m = (m - 1.0) + torch.where(low, m, torch.zeros_like(m))
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y = _fma32(_fma32(m, p[0], p[1]), m, p[2])
    y1 = _fma32(_fma32(m, p[3], p[4]), m, p[5])
    y2 = _fma32(_fma32(m, p[6], p[7]), m, p[8])
    y = _fma32(_fma32(y, x3, y1), x3, y2)
    y = _fma32(y, x3, _LOG_Q1 * e)
    m = m - 0.5 * x2
    m = m + y
    return m + _LOG_Q2 * e


def gumbel_noise(seed: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) standard Gumbel noise, bit-equal to the reference's
    ``jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed[b]),
    pos[b]), (n,))`` (threefry2x32 with partitionable random bits). seed
    holds uint32 stream ids, pos int32 positions (any integer dtype; both are
    reduced mod 2**32, as JAX's uint32 conversion does).

    PRNGKey(s) is the pair (0, s); fold_in(key, p) is threefry(key, (0, p));
    bit i of the row is the xor of the two words of threefry(key, (0, i));
    the top 23 bits become a uniform f in [0, 1), u = max(tiny, f + tiny),
    and the noise is -log(-log(u))."""
    seed = seed.long() & _M32
    pos = pos.long() & _M32
    zero = torch.zeros_like(seed)
    k0, k1 = _threefry2x32(zero, seed, zero, pos)
    col = torch.arange(n, device=seed.device, dtype=torch.int64)[None, :]
    b0, b1 = _threefry2x32(k0[:, None], k1[:, None], torch.zeros_like(col), col)
    f = (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp_min(f + tiny, tiny)  # f * (1 - tiny) + tiny; 1 - tiny == 1 in f32
    return -_xla_log(-_xla_log(u))


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
    only on (stream seed, position) (gumbel_noise, the reference's threefry
    stream bit for bit), so a request re-samples the same token at a position
    after preemption-recompute or in another batch.

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
