"""ops — the public kernel API of the port, with impl dispatch.

Port of ``repro.kernels.ops``: the serving paths' kernels (dense attention
and decode, paged attention, the quantized matmul, the Mamba-2 SSD scan, the
RG-LRU recurrence) and the paper-suite dispatchers (``sum3d`` / ``matvec`` /
``tinymatsum`` / ``stencil3d``), where an MdSpan's layout type selects the
kernel schedule.
``impl`` replaces the reference's ``_want_pallas``:

  "cuda"   the hand-written kernel; raises unless the operands are CUDA tensors
  "torch"  the plain PyTorch version
  "auto"   the kernel for CUDA tensors, the plain version for CPU tensors

``sample_tokens``, ``verify_draft_tokens`` and ``ssd_decode_step`` are plain
PyTorch in the reference too (jnp, not Pallas), so they have no kernel here
either; a dense ``matmul``
is ``torch.matmul``, as the reference leaves it to XLA.
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from repro_torch.core.layouts import LayoutLeft, LayoutRight
from repro_torch.core.mdspan import MdSpan

from .flash_attention import (
    attention_torch,
    decode_attention_torch,
    flash_attention,
    flash_decode,
)
from .flash_vjp import FlashAttentionFn, flash_attention_torch
from .matvec import matvec_left, matvec_right, matvec_torch
from .paged_attention import (
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
from .rglru_scan import rglru_scan as _rglru_kernel
from .rglru_scan import rglru_torch
from .ssd_scan import ssd_scan, ssd_torch
from .stencil3d import stencil3d as _stencil3d_kernel
from .stencil3d import stencil3d_torch
from .sum3d import sum3d as _sum3d_kernel
from .sum3d import sum3d_mdspan, sum3d_torch
from .tinymatsum import tinymatsum_dynamic, tinymatsum_static, tinymatsum_torch

IMPLS = ("auto", "cuda", "torch")


def _want_kernel(impl: str, x) -> bool:
    """Whether to launch the kernel for operands on ``x``'s device (a tensor,
    or a torch.device)."""
    device = x if isinstance(x, torch.device) else x.device
    if impl == "torch":
        return False
    if impl == "cuda":
        if device.type != "cuda":
            raise ValueError(f"impl='cuda' needs CUDA tensors, got {device}")
        return True
    if impl == "auto":
        return device.type == "cuda"
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
# dense attention: monolithic prefill and one-token decode over a dense cache
# ---------------------------------------------------------------------------------
def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset=0, scale: Optional[float] = None, impl: str = "auto",
              block_k: int = 512) -> torch.Tensor:
    """GQA attention, q (B, Hq, Tq, D) against k/v (B, Hkv, Tk, D): query row
    i at absolute position i + q_offset (an int or a 0-d tensor), optional
    causal mask and local window, f32 sums, fully masked rows output 0. The
    kernel is flash_attention (contiguous operands); the plain version is the
    reference's blocked ``attention_jnp`` (``block_k`` keys a block).

    With grad mode on and any of q, k, v requiring grad, the result is
    differentiable, as the reference's ``flash_attention_jnp``: on CUDA
    through ``flash_vjp.FlashAttentionFn`` (flash_attention forward,
    flash_attention_bwd backward), with ``impl="torch"`` or on the CPU
    through the plain ``flash_vjp.flash_attention_torch``."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        if _want_kernel(impl, q):
            return FlashAttentionFn.apply(q, k, v, causal, window, q_offset, scale)
        return flash_attention_torch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                     scale=scale, block_k=block_k)
    if _want_kernel(impl, q):
        return flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               scale=scale)
    return attention_torch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                           scale=scale, block_k=block_k)


def decode_attention(q, k_cache, v_cache, pos, *, window: Optional[int] = None,
                     scale: Optional[float] = None, impl: str = "auto") -> torch.Tensor:
    """One-token GQA decode against a dense (B, Hkv, S, D) cache; ``pos`` (an
    int or a 0-d tensor) is the current token's slot, slots past it are
    masked. The kernel is flash_decode; the plain version is ``attention``
    with Tq == 1, causal, q_offset = pos, as in the reference."""
    if _want_kernel(impl, q):
        return flash_decode(q, k_cache, v_cache, pos, window=window, scale=scale)
    return decode_attention_torch(q, k_cache, v_cache, pos, window=window, scale=scale)


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
# SSD scan (Mamba-2)
# ---------------------------------------------------------------------------------
def ssd(x, dt, A, B, C, *, chunk: int = 64, initial_state=None,
        return_final_state: bool = False, impl: str = "auto"):
    """Mamba-2 chunked SSD scan. Under "auto", the ssd_scan kernel on CUDA
    tensors for ngroups 1 (B.shape[2] == 1) and the plain chunked version
    otherwise, as the reference dispatches; "cuda" always takes the kernel,
    which refuses ngroups > 1."""
    kw = dict(chunk=chunk, initial_state=initial_state, return_final_state=return_final_state)
    if _want_kernel(impl, x) and (impl == "cuda" or B.shape[2] == 1):
        return ssd_scan(x, dt, A, B, C, **kw)
    return ssd_torch(x, dt, A, B, C, **kw)


def ssd_decode_step(state, xt, dtt, A, Bt, Ct):
    """Single-token SSM state update (decode), plain PyTorch as in the
    reference. state (b, h, p, n) f32; xt (b, h, p); dtt (b, h); Bt / Ct (b,
    g, n). Returns (new state, y (b, h, p) in xt's dtype)."""
    rep = state.shape[1] // Bt.shape[1]
    Bh = Bt.repeat_interleave(rep, dim=1).float()
    Ch = Ct.repeat_interleave(rep, dim=1).float()
    decay = torch.exp(dtt.float() * A.float()[None, :])
    upd = (dtt.float()[..., None] * xt.float())[..., None] * Bh[:, :, None, :]
    state = state * decay[..., None, None] + upd
    y = torch.einsum("bhpn,bhn->bhp", state, Ch)
    return state, y.to(xt.dtype)


# ---------------------------------------------------------------------------------
# RG-LRU recurrence (recurrentgemma)
# ---------------------------------------------------------------------------------
def rglru_scan(a, b, *, initial_state=None, return_final_state: bool = False,
               impl: str = "auto"):
    """h_t = a_t * h_{t-1} + b_t over dim 1 of (B, T, W), from an optional f32
    initial state (B, W): y in a's dtype [and the f32 final state]. The
    kernel is rglru_scan (any T, so the reference's ragged-tail padding has
    nothing to do); the plain version is the reference model's associative
    scan."""
    kw = dict(initial_state=initial_state, return_final_state=return_final_state)
    if _want_kernel(impl, a):
        return _rglru_kernel(a, b, **kw)
    return rglru_torch(a, b, **kw)


# ---------------------------------------------------------------------------------
# paper-suite dispatchers (layout-generic)
# ---------------------------------------------------------------------------------
def sum3d(span, *, impl: str = "auto") -> torch.Tensor:
    """Sum of a rank-3 MdSpan (or plain tensor) in f32. On an MdSpan the
    layout picks the physical schedule (kernels.sum3d.sum3d_mdspan). A plain
    tensor is read as LayoutRight storage: the kernel runs on it as stored
    (it must be contiguous) where ``impl`` asks for the kernel, and the plain
    version runs otherwise, as the reference sends plain arrays to it."""
    want = _want_kernel(impl, span.device)
    if not isinstance(span, MdSpan):
        return _sum3d_kernel(span) if want else sum3d_torch(span)
    if want:
        return sum3d_mdspan(span)
    return sum3d_torch(span.to_dense())


def matvec(A_span, x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """y = A @ x. Layout dispatch: LayoutRight -> matvec_right over the
    codomain as (I, J), LayoutLeft -> matvec_left over it as (J, I), both read
    as stored (paper Fig. 6); any other layout is gathered to (I, J) first. A
    plain tensor A is read as LayoutRight storage, as in sum3d."""
    want = _want_kernel(impl, A_span.device)
    if not isinstance(A_span, MdSpan):
        return matvec_right(A_span, x) if want else matvec_torch(A_span, x)
    if not want:
        return matvec_torch(A_span.to_dense(), x)
    if isinstance(A_span.layout, LayoutRight):
        return matvec_right(A_span.codomain().reshape(A_span.shape), x)
    if isinstance(A_span.layout, LayoutLeft):
        return matvec_left(A_span.codomain().reshape(A_span.shape[::-1]), x)
    return matvec_right(A_span.to_dense(), x)


def tinymatsum(o: torch.Tensor, s: torch.Tensor, *, static_extents: bool = True,
               impl: str = "auto", **kw) -> torch.Tensor:
    """o + s over (N, J, K) tiny matrices; ``static_extents`` picks the kernel
    with J, K as template arguments or as runtime ints (paper Fig. 5); ``kw``
    goes to the dynamic kernel (jmax, kmax)."""
    if not _want_kernel(impl, o):
        return tinymatsum_torch(o, s)
    if static_extents:
        return tinymatsum_static(o, s, **kw)
    return tinymatsum_dynamic(o, s, **kw)


def stencil3d(x: torch.Tensor, *, impl: str = "auto") -> torch.Tensor:
    """The 27-point box stencil of a rank-3 tensor (interior; boundary 0)."""
    if not _want_kernel(impl, x):
        return stencil3d_torch(x)
    return _stencil3d_kernel(x)


# ---------------------------------------------------------------------------------
# on-device token sampling
# ---------------------------------------------------------------------------------
_M32 = 0xFFFFFFFF


def top_k_lower_id_first(x: torch.Tensor, k: int):
    """(values, ids int64) of the k largest f32 entries of each row, ordered
    by (-value, id) as ``jax.lax.top_k`` orders ties (the lower id first),
    which torch.topk does not promise: the key is the value's
    order-preserving int32 bits above the inverted id, and an int64 topk
    over it."""
    bits = (x.float() + 0.0).view(torch.int32).long()  # -0.0 -> +0.0
    ordered = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF)  # float order as ints
    ids = torch.arange(x.shape[-1], device=x.device, dtype=torch.int64)
    top = torch.topk(ordered * (1 << 32) + (_M32 - ids), k, dim=-1).indices
    return x.gather(-1, top), top
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


# fold_in domain tags of the speculative verify (the reference's
# ``repro.kernels.ops.SPEC_ACCEPT_FOLD`` / ``SPEC_RESAMPLE_FOLD``): each (stream,
# position) base key fans out into an acceptance-uniform and a resample-Gumbel
# stream, disjoint from sample_tokens' draws (which fold no tag).
SPEC_ACCEPT_FOLD = 0x5ACC
SPEC_RESAMPLE_FOLD = 0x5E5A


def position_keys(seed: torch.Tensor, pos: torch.Tensor):
    """The key pair (k0, k1) of ``jax.random.fold_in(jax.random.PRNGKey(seed),
    pos)``, elementwise over broadcast seed / pos: PRNGKey(s) is (0, s) and
    fold_in(key, p) is threefry(key, (0, p)). seed holds uint32 stream ids,
    pos positions (any integer dtype; both reduced mod 2**32, as JAX's uint32
    conversion does). Returns int64 tensors holding uint32 values."""
    seed = seed.long() & _M32
    pos = pos.long() & _M32
    seed, pos = torch.broadcast_tensors(seed, pos)
    zero = torch.zeros_like(seed)
    return _threefry2x32(zero, seed, zero, pos)


def fold_in(k0: torch.Tensor, k1: torch.Tensor, data: int):
    """``jax.random.fold_in(key, data)`` for a key pair and a uint32 tag."""
    return _threefry2x32(k0, k1, torch.zeros_like(k0), torch.full_like(k0, data & _M32))


def _unit_floats(k0: torch.Tensor, k1: torch.Tensor, n: Optional[int]) -> torch.Tensor:
    """JAX's uniform [0, 1) f32 draw of a key under partitionable threefry
    bits: element i is the xor of the two words of threefry(key, (0, i)),
    whose top 23 bits become the mantissa of a float in [1, 2), minus 1.
    ``n`` None draws the scalar (element 0, as a shape () draw takes); else
    (..., n) from keys (...)."""
    if n is None:
        b0, b1 = _threefry2x32(k0, k1, torch.zeros_like(k0), torch.zeros_like(k0))
    else:
        col = torch.arange(n, device=k0.device, dtype=torch.int64)
        b0, b1 = _threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(col), col)
    return (((b0 ^ b1) >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0


def uniform_from_key(k0: torch.Tensor, k1: torch.Tensor) -> torch.Tensor:
    """``jax.random.uniform(key)`` (shape (), [0, 1)) for each key pair, bit
    for bit: max(0, f * 1 + 0) is f."""
    return _unit_floats(k0, k1, None)


def gumbel_from_key(k0: torch.Tensor, k1: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` for each key pair (...): (..., n),
    bit for bit. u = max(tiny, f * (1 - tiny) + tiny), where 1 - tiny == 1 in
    f32, and the noise is -log(-log(u)) with XLA's rounding of log."""
    f = _unit_floats(k0, k1, n)
    tiny = torch.finfo(torch.float32).tiny
    u = torch.clamp_min(f + tiny, tiny)
    return -_xla_log(-_xla_log(u))


def gumbel_noise(seed: torch.Tensor, pos: torch.Tensor, n: int) -> torch.Tensor:
    """(B, n) standard Gumbel noise, bit-equal to the reference's
    ``jax.random.gumbel(jax.random.fold_in(jax.random.PRNGKey(seed[b]),
    pos[b]), (n,))`` (threefry2x32 with partitionable random bits)."""
    return gumbel_from_key(*position_keys(seed, pos), n)


def _filter_topk_topp(x, temperature, top_k, top_p, *, vocab: int):
    """Temperature-scale + top-k/top-p filter a batch of masked logit rows
    (pad columns already -inf). Returns z = x / max(temperature, eps) with the
    filtered-out entries at -inf: top-k keeps the k largest (ties at the k-th
    value all kept), then top-p keeps the smallest head of the scaled
    distribution whose mass reaches top_p (the crossing token included).
    Shared by sample_tokens and verify_draft_tokens, so the speculative
    accept test and ordinary sampling see the same distribution."""
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
                  sampled: Optional[bool] = None, mask=None) -> torch.Tensor:
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
    the sort/softmax work and costs one argmax.

    ``mask`` (optional, (B, vocab) f32) is an ADDITIVE logit mask, the
    constrained-decoding stage: added in f32 after the cast and before every
    filter and both selection paths, so top-k / top-p act on the constrained
    distribution and greedy picks the best allowed token. Disallowed tokens
    carry ``serving.grammar.MASK_OFF``; an all-zero row is an exact no-op; the
    pad columns stay -inf."""
    vp = logits.shape[1]
    col = torch.arange(vp, device=logits.device)[None, :]
    x = torch.where(col < vocab, logits.float(), torch.full_like(logits, -math.inf, dtype=torch.float32))
    if mask is not None:
        x = x + torch.nn.functional.pad(mask.float(), (0, vp - vocab))
    greedy = torch.argmax(x, dim=-1).to(torch.int32)
    if sampled is None:
        sampled = bool((temperature > 0).any())
    if not sampled:
        return greedy
    z = _filter_topk_topp(x, temperature, top_k, top_p, vocab=vocab)
    g = gumbel_noise(seed, pos, vp)
    tok = torch.argmax(z + g, dim=-1).to(torch.int32)
    return torch.where(temperature > 0, tok, greedy)


def verify_draft_tokens(logits, draft, temperature, top_k, top_p, seed, pos0, active, *,
                        vocab: int, sampled: Optional[bool] = None):
    """Speculative accept / resample over one verify window's logits.

    logits (B, C, Vp): the target model's rows for present positions lens ..
    lens + K (C = K + 1; row j predicts the token at absolute position
    pos0[b] + j, pos0 = lens + 1); draft (B, K) proposed tokens (clipped to
    the vocabulary: a garbage proposal is rejected, never a crash);
    temperature / top_k / top_p / seed (B,): the rows sample_tokens takes;
    active (B,): the phase bitmap.

    Returns (tokens_out (B, C) int32, committed (B,) int32, chosen_lp (B, C)
    f32): the first committed[b] = n_acc + 1 entries of tokens_out[b] are
    final, n_acc accepted draft tokens then one correction (first rejection)
    or bonus (all accepted) token; inactive rows commit 0. chosen_lp is the
    unmasked log-probability of every tokens_out entry.

    Greedy rows (temperature 0): tokens_out is the argmax of each row and
    draft j is accepted where argmax_j == draft_j, so the committed stream is
    the one-token-at-a-time greedy stream. Sampled rows accept d_j with
    probability p_j(d_j) under the distribution sample_tokens draws from
    (_filter_topk_topp), resample the first rejection with d_j masked out,
    and draw the bonus row unmasked; the uniform and the noise come from
    fold_in(fold_in(PRNGKey(seed), pos0 + j), SPEC_ACCEPT_FOLD /
    SPEC_RESAMPLE_FOLD), the reference's bits. ``sampled``: the caller's
    host-side knowledge of whether any row has temperature > 0 (None: read it
    from the device, one sync), in place of the reference's lax.cond."""
    b, c, vp = logits.shape
    k = c - 1
    col = torch.arange(vp, device=logits.device)
    x = torch.where(col < vocab, logits.float(), torch.full_like(logits, -math.inf,
                                                                   dtype=torch.float32))
    greedy = torch.argmax(x, dim=-1).to(torch.int32)  # (B, C)
    draft = torch.clamp(draft.to(torch.int32), 0, vocab - 1)
    accept = greedy[:, :k] == draft  # (B, K)
    tokens_out = greedy
    if sampled is None:
        sampled = bool((temperature > 0).any())
    if sampled:
        z = _filter_topk_topp(
            x.reshape(b * c, vp), temperature.repeat_interleave(c),
            top_k.repeat_interleave(c), top_p.repeat_interleave(c), vocab=vocab,
        ).reshape(b, c, vp)
        pos = pos0.long()[:, None] + torch.arange(c, device=logits.device)[None, :]
        k0, k1 = position_keys(seed[:, None], pos)  # (B, C)
        u = uniform_from_key(*fold_in(k0, k1, SPEC_ACCEPT_FOLD))
        g = gumbel_from_key(*fold_in(k0, k1, SPEC_RESAMPLE_FOLD), vp)  # (B, C, Vp)
        probs = torch.softmax(z, dim=-1)
        d = draft.long()[:, :, None]
        acc = u[:, :k] < probs[:, :k].gather(-1, d)[..., 0]
        zm = z.clone()
        zm[:, :k].scatter_(-1, d, -math.inf)  # the rejected draft token is out
        resamp = torch.argmax(zm + g, dim=-1).to(torch.int32)  # (B, C)
        acc_f = torch.cat([acc, torch.zeros_like(acc[:, :1])], dim=1)
        draft_f = torch.cat([draft, torch.zeros_like(draft[:, :1])], dim=1)
        tok = torch.where(acc_f, draft_f, resamp)
        samp = (temperature > 0)[:, None]
        tokens_out = torch.where(samp, tok, greedy)
        accept = torch.where(samp, acc, accept)
    n_acc = torch.cumprod(accept.to(torch.int32), dim=1).sum(dim=1)
    committed = torch.where(active > 0, n_acc + 1, torch.zeros_like(n_acc)).to(torch.int32)
    lp = torch.log_softmax(logits[..., :vocab].float(), dim=-1)
    chosen_lp = lp.gather(-1, tokens_out.long()[..., None])[..., 0]
    return tokens_out, committed, chosen_lp
