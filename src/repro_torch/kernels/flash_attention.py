"""Dense-cache GQA flash attention: the plain PyTorch versions and the
wrappers that launch the hand-written CUDA kernels.

Port of ``repro.kernels.flash_attention`` (and of the jnp twins the
reference's ``ops.attention`` / ``ops.decode_attention`` fall back to):

  attention_torch         <- ops.attention_jnp (the blocked online-softmax twin)
  decode_attention_torch  <- ops.decode_attention's jnp path: attention_torch
                             with Tq == 1, causal, q_offset = pos
  flash_attention         <- flash_attention (Pallas) — launches
                             csrc/flash_attention.cu::flash_mma_kernel on
                             bf16 (tensor cores), flash_kernel on f32
  decode_partials_torch   the decode kernel's per-split partials over the
                             dense cache (plain; no reference namesake)
  flash_decode            <- flash_decode (Pallas) — launches the split-K decode
                             body the paged decodes share
                             (csrc/decode_splitk.cuh::split_decode_kernel
                             over DenseKeys), then the log-sum-exp combine

q (B, Hq, Tq, D), k / v (B, Hkv, Tk, D), Hq a multiple of Hkv (GQA). Query
row i sits at absolute position i + q_offset; keys past Tk, after the query
(causal) or at or before q_pos - window (window set) are dead; fully masked
rows output 0. ``q_offset`` / ``pos`` is an int or a 0-d integer tensor on
q's device, which the kernel reads on the device (no host sync).

A wrapper given CPU tensors returns its plain version; given CUDA tensors it
launches its kernel or raises on what the kernel does not take. Each wrapper
counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from . import _build
from .common import no_dtensor, no_grad_through
from . import paged_attention as _paged
from .paged_attention import _DTYPE_CODE, HEAD_DIMS, NEG_INF, _check


# ---------------------------------------------------------------------------------
# plain PyTorch versions
# ---------------------------------------------------------------------------------
def attention_torch(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset=0, scale: Optional[float] = None, block_k: int = 512,
                    return_lse: bool = False):
    """Blocked online-softmax GQA attention, the reference's ``attention_jnp``:
    f32 sums, memory O(Tq * block_k). Dead scores are zeroed through ``*
    live``, never through exp() alone, so a fully masked row outputs 0 (the
    reference's twin gives it the mean of V: exp(NEG_INF - NEG_INF) == 1).
    ``return_lse`` also returns the f32 (B, Hq, Tq) log-sum-exp of the scaled
    scores (NEG_INF on a row with no live key), the reference's ``_fwd_impl``'s
    second output."""
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
        p = torch.exp(s - m_new) * live
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    l_safe = torch.where(l == 0, torch.ones_like(l), l)
    out = (acc / l_safe).to(q.dtype)
    if return_lse:
        return out, (m + torch.log(l_safe))[..., 0]
    return out


def _local_pos(pos, key_offset: int):
    """The current token's slot in a cache whose slot 0 is key ``key_offset``
    (a rank's slice of a sequence-split cache): ``pos - key_offset``, on the
    device for a tensor ``pos``. Negative: the slice lies wholly after the
    token (no live key); at or past the slice's end: every slot is live."""
    if not key_offset:
        return pos
    if isinstance(pos, torch.Tensor):
        return pos.reshape(()) - int(key_offset)
    return int(pos) - int(key_offset)


def decode_attention_torch(q, k_cache, v_cache, pos, *, window: Optional[int] = None,
                           scale: Optional[float] = None, key_offset: int = 0,
                           return_lse: bool = False):
    """One-token decode against a (B, Hkv, S, D) cache: slot ``pos`` is the
    current token, slots past it are masked (the reference's jnp twin).
    ``key_offset``: slot 0 holds key ``key_offset`` (``_local_pos``).
    ``return_lse`` also returns the f32 (B, Hq, 1) natural log-sum-exp of the
    scaled scores, -inf on a row with no live key (whose output is 0)."""
    pos = _local_pos(pos, key_offset)
    out = attention_torch(q, k_cache, v_cache, causal=True, window=window, q_offset=pos,
                          scale=scale, return_lse=return_lse)
    if not return_lse:
        return out
    out, lse = out
    return out, torch.where(lse <= NEG_INF, torch.full_like(lse, -math.inf), lse)


def decode_partials_torch(q, k_cache, v_cache, pos, *, keys_per_split: int,
                          window: Optional[int] = None, scale: Optional[float] = None,
                          key_offset: int = 0):
    """The split-K decode's partials over a dense cache: slots [s * K, (s +
    1) * K) (K = ``keys_per_split``) are split s, slot j live iff j <= pos
    and, with a window, j > pos - window (paged_attention's
    split_partials_torch), pos counted from ``key_offset`` (``_local_pos``).
    Returns m, l (B, Hq, splits) and acc (B, Hq, splits, D), f32;
    ``combine_splits_torch`` of them is the decode."""
    b, _, _, d = q.shape
    s_len = k_cache.shape[2]
    pos = _local_pos(pos, key_offset)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    j = torch.arange(s_len, device=q.device)
    live = j <= pos
    if window is not None:
        live = live & (j > pos - window)
    return _paged.split_partials_torch(q, k_cache, v_cache, live.expand(b, s_len),
                                       keys_per_split=keys_per_split, scale=scale)


# ---------------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------------
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = _build.Binding("flash_attention", {
    "repro_flash_attention": [_i, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                              _i, _f, _p],
    "repro_flash_decode": [_i, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _i, _i, _i, _i,
                           _i, _f, _p],
})


def _check_qkv(q, k, v) -> None:
    _check("q", q, ndim=4)
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        _check(name, t, ndim=4, dtype=q.dtype, device=q.device)
    if k.shape != v.shape:
        raise ValueError(f"k {tuple(k.shape)} != v {tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} disagree on B or D")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} not supported: the kernel takes {HEAD_DIMS}")
    if hq % k.shape[1]:
        raise ValueError(f"Hq {hq} not a multiple of Hkv {k.shape[1]}")


def _offset(x, device):
    """(device pointer, int) for an int or a 0-d integer tensor on ``device``:
    a tensor is read by the kernel (pointer set), an int passed by value."""
    if isinstance(x, torch.Tensor):
        if x.device != device or x.numel() != 1:
            raise ValueError(f"a tensor offset must be one integer on {device}, got "
                             f"{tuple(x.shape)} on {x.device}")
        if x.dtype != torch.int32:
            x = x.to(torch.int32)
        return x.contiguous(), 0
    return None, int(x)


def _window(window):
    if window is None:
        return 0, 0
    if int(window) < 1:
        raise ValueError(f"window must be >= 1, got {window}")
    return 1, int(window)


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset=0, scale: Optional[float] = None,
                    lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """GQA flash attention, 64 query rows a block (kernel: flash_mma_kernel
    on the tensor cores for bfloat16, flash_kernel's f32 CUDA-core products
    for float32). On CUDA: q, k, v contiguous, one of float32/bfloat16, D in
    HEAD_DIMS, bfloat16 ones on 16-byte boundaries (the kernel copies 16
    bytes at a time); Tq and Tk free (Tq != Tk allowed). Output in q's dtype.
    ``lse``, a contiguous f32 (B, Hq, Tq) tensor on q's device, receives each
    row's log-sum-exp (the backward's input; serving passes none). A gradient
    goes through ``flash_vjp.FlashAttentionFn``, never through this wrapper.
    A DTensor is refused (``no_dtensor``): sharded callers run it inside
    ``local_map``."""
    no_dtensor("flash_attention", q, k, v)
    if q.device.type == "cpu":
        return attention_torch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                               scale=scale)
    no_grad_through("flash_attention", q, k, v)
    _check_qkv(q, k, v)
    if lse is not None:
        _check("lse", lse, ndim=3, dtype=torch.float32, device=q.device)
        if tuple(lse.shape) != tuple(q.shape[:3]):
            raise ValueError(f"lse {tuple(lse.shape)} must be {tuple(q.shape[:3])}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    off_t, off = _offset(q_offset, q.device)
    has_w, w = _window(window)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    out = torch.empty_like(q)
    _LIB.launch(
        "repro_flash_attention", "flash_attention",
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        lse.data_ptr() if lse is not None else None,
        off_t.data_ptr() if off_t is not None else None, off, b, hq, hkv, tq, tk, d,
        int(bool(causal)), has_w, w, scale, device=q.device,
    )
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def flash_decode(q, k_cache, v_cache, pos, *, window: Optional[int] = None,
                 scale: Optional[float] = None, key_offset: int = 0,
                 lse: Optional[torch.Tensor] = None) -> torch.Tensor:
    """One-token GQA decode against a dense cache (kernel: the split-K decode
    body over the cache's slots, split as plan_decode_splits picks for S
    one-slot pages, then the combine). q (B, Hq, 1, D); caches (B, Hkv, S,
    D), on 16-byte boundaries (the kernel loads 16 bytes at a time); ``pos``
    the current token's slot (an int or a 0-d integer tensor on q's device,
    never read on the host). Any GQA group: G > 8 takes ceil(G / 8) blocks
    per split. Output in q's dtype.

    A rank's slice of a sequence-split cache: ``key_offset`` is the global
    key its slot 0 holds, and the kernel attends slot j <= pos - key_offset
    (computed on the device for a tensor ``pos``; negative: no live key,
    the rows come out 0; past the slice: every slot live). ``lse``, a
    contiguous f32 (B, Hq, 1) tensor on q's device, receives each row's
    natural log-sum-exp of the scaled scores (-inf with no live key), from
    the combine's compile-time lse epilogue; the one-device decode passes
    none and runs the combine it always ran. On the CPU the plain version
    fills it."""
    no_dtensor("flash_decode", q, k_cache, v_cache)
    if q.device.type == "cpu":
        if lse is None:
            return decode_attention_torch(q, k_cache, v_cache, pos, window=window, scale=scale,
                                          key_offset=key_offset)
        out, got = decode_attention_torch(q, k_cache, v_cache, pos, window=window, scale=scale,
                                          key_offset=key_offset, return_lse=True)
        lse.copy_(got)
        return out
    no_grad_through("flash_decode", q, k_cache, v_cache)
    _check_qkv(q, k_cache, v_cache)
    b, hq, tq, d = q.shape
    _, hkv, s_len, _ = k_cache.shape
    if tq != 1:
        raise ValueError(f"decode wants one query token, got q {tuple(q.shape)}")
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache)):
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary")
    if lse is not None:
        _check("lse", lse, ndim=3, dtype=torch.float32, device=q.device)
        if tuple(lse.shape) != (b, hq, 1):
            raise ValueError(f"lse {tuple(lse.shape)} must be {(b, hq, 1)}")
    pos_t, p = _offset(_local_pos(pos, key_offset), q.device)
    has_w, w = _window(window)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    splits, kps, ws = _paged._decode_split(q, hkv, 1, s_len)
    out = torch.empty_like(q)
    _LIB.launch(
        "repro_flash_decode", "flash_decode",
        _DTYPE_CODE[q.dtype], q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
        out.data_ptr(), ws.data_ptr(), lse.data_ptr() if lse is not None else None,
        pos_t.data_ptr() if pos_t is not None else None, p, b, hq, hkv, s_len, d, has_w, w,
        splits, kps, scale, device=q.device,
    )
    flash_decode.launches += 1
    return out


flash_decode.launches = 0

KERNEL_WRAPPERS = {"flash_attention": flash_attention, "flash_decode": flash_decode}
