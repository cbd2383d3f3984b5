"""Differentiable flash attention: the plain backward and the CUDA one.

Port of ``repro.kernels.flash_vjp``: the reference trains through
``flash_attention_jnp``, a ``jax.custom_vjp`` whose backward (``_bwd``) is
written by hand and saves only (q, k, v, out, lse), recomputing P per key
block:

    P_j   = exp(q . k_j^T * s - lse)        zero on dead pairs
    dV_j  = P_j^T . dO
    dP_j  = dO . v_j^T
    delta = rowsum(dO o O)
    dS_j  = P_j o (dP_j - delta) * s
    dQ   += dS_j . k_j ;  dK_j = dS_j^T . q

Here the custom_vjp is a ``torch.autograd.Function``:

  flash_attention_torch  the plain version: forward is
                         ``attention_torch(..., return_lse=True)`` (blocked,
                         f32 sums, a fully masked row outputs 0), backward is
                         ``flash_bwd_torch``, ``_bwd`` block for block
  FlashAttentionFn       the CUDA twin: forward on flash_attention's kernel
                         with its lse output, backward on
                         ``flash_attention_bwd`` (csrc/flash_attention_bwd.cu)

Both save only (q, k, v, out, lse). Semantics as ``ops.attention``: GQA,
causal, a local window, ``q_offset`` an int or a 0-d integer tensor, Tq !=
Tk. ``flash_attention_bwd`` counts its launches in ``.launches``; given CPU
tensors it returns ``flash_bwd_torch``'s result.

On the card, bf16 runs the tensor-core kernels (a dQ kernel, then a dK/dV
kernel a block per 64 keys); ``bwd_plan`` cuts each key tile's dK/dV walk
over the GQA group's query heads and query tiles into splits where the grid
is under one wave of resident blocks (the occupancy query), and a fold sums
the splits' f32 partials in split order. ``flash_bwd_split_torch`` is the
plain twin of that schedule (``kv_walk``, ``split_range``), which the CPU
tests hold to the plain backward and the reference's VJP. f32 keeps the
CUDA-core kernels and never splits.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import _build
from .common import cdiv
from .flash_attention import (
    _DTYPE_CODE,
    _check,
    _check_qkv,
    _offset,
    _window,
    attention_torch,
    flash_attention,
)
from .paged_attention import sm_count

# csrc/flash_attention_bwd.cu's kGeometry, in its order: the f32 bodies'
# threads a block and (query rows, keys) a tile up to D 128 and at D 256; the
# bf16 bodies' warps a block (16 keys or 16 query rows each), query rows a
# tile of the dK/dV walk at D <= 64 and above, the dK/dV column split at D
# 256, keys a tile of the dQ walk up to D 128 and at D 256, the cp.async
# ring's stages and the most splits of a key tile's walk; the library is
# checked against it when it loads
GEOMETRY = {"threads": 256, "rows": 64, "keys": 64, "rows_d256": 32, "keys_d256": 32,
            "warps": 4, "kv_rows": 64, "kv_rows_wide": 32, "kv_col_split_d256": 2,
            "dq_keys": 64, "dq_keys_d256": 32, "stages": 2, "max_splits": 16}


class BwdTiles(NamedTuple):
    kv_keys: int  # keys a dK/dV block
    kv_rows: int  # query rows a tile of its walk
    dq_rows: int  # query rows a dQ block
    dq_keys: int  # keys a tile of its walk


def tiles(d: int, dtype: torch.dtype) -> BwdTiles:
    """The backward kernels' tiles at head dim ``d`` for ``dtype``."""
    g = GEOMETRY
    if dtype == torch.float32:
        rows, keys = (g["rows_d256"], g["keys_d256"]) if d > 128 else (g["rows"], g["keys"])
        return BwdTiles(keys, rows, rows, keys)
    return BwdTiles(16 * g["warps"], g["kv_rows"] if d <= 64 else g["kv_rows_wide"],
                    16 * g["warps"], g["dq_keys"] if d <= 128 else g["dq_keys_d256"])


class BwdPlan(NamedTuple):
    splits: int                    # pieces of each key tile's dK/dV walk
    kv_grid: Tuple[int, int, int]  # (key tiles x splits, Hkv, B)
    dq_grid: Tuple[int, int, int]  # (query tiles, Hq, B)


def bwd_plan(b: int, hq: int, hkv: int, tq: int, tk: int, d: int, dtype: torch.dtype,
             sms: int, blocks_per_sm: int) -> BwdPlan:
    """The backward's launch plan. bf16 splits each key tile's walk (the
    group's query heads, then their query tiles) only while the (key tile,
    kv head, sequence) grid is under one wave, ``sms`` x ``blocks_per_sm``
    resident dK/dV blocks: into the fewest splits that fill the wave, at most
    GEOMETRY["max_splits"] and at most the longest walk's items. f32 never
    splits."""
    t = tiles(d, dtype)
    key_tiles = cdiv(tk, t.kv_keys)
    base = key_tiles * hkv * b
    wave = sms * blocks_per_sm
    splits = 1
    if dtype != torch.float32 and base < wave:
        walk = hq // hkv * cdiv(tq, t.kv_rows)
        splits = max(1, min(GEOMETRY["max_splits"], cdiv(wave, base), walk))
    return BwdPlan(splits, (key_tiles * splits, hkv, b), (cdiv(tq, t.dq_rows), hq, b))


def grid_blocks(b: int, hq: int, hkv: int, tq: int, tk: int, d: int, dtype: torch.dtype,
                splits: int = 1):
    """(dK/dV blocks, dQ blocks) of one backward launch with ``splits``."""
    t = tiles(d, dtype)
    return cdiv(tk, t.kv_keys) * splits * hkv * b, cdiv(tq, t.dq_rows) * hq * b


def kv_walk(j0: int, tq: int, tk: int, q_offset: int, causal: bool, window: Optional[int],
            rows: int, keys: int):
    """(t_lo, query tiles) of the dK/dV walk of keys [j0, j0 + keys): the
    rows that can see them start at t_lo (the causal start, down to a
    multiple of ``rows``) and end before the window's end; the kernel's
    dkdv_mma_kernel computes the same."""
    j_last = min(j0 + keys, tk) - 1
    t_lo = max(0, j0 - q_offset) // rows * rows if causal else 0
    t_hi = min(tq, j_last + window - q_offset) if window is not None else tq
    return t_lo, cdiv(t_hi - t_lo, rows) if t_hi > t_lo else 0


def split_range(n_items: int, splits: int, s: int):
    """Items [begin, end) of a walk of ``n_items`` that split ``s`` takes."""
    return s * n_items // splits, (s + 1) * n_items // splits


# ---------------------------------------------------------------------------------
# plain PyTorch backward
# ---------------------------------------------------------------------------------
def flash_bwd_torch(q, k, v, out, dout, lse, *, causal: bool = True,
                    window: Optional[int] = None, q_offset=0, scale: Optional[float] = None,
                    block_k: int = 512):
    """The reference's ``_bwd`` over key blocks of ``block_k``: -> (dq, dk,
    dv) in the inputs' dtypes. P is recomputed from ``lse`` and zeroed on dead
    pairs by liveness (a fully masked row has lse NEG_INF and zero
    gradients); GQA folds each kv head's group of query heads back onto it.
    Its calls are counted in ``.calls``."""
    flash_bwd_torch.calls += 1
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    qf, do, of = q.float(), dout.float(), out.float()
    delta = (do * of).sum(dim=-1, keepdim=True)
    q_pos = torch.arange(tq, device=q.device)[:, None] + q_offset
    dq = torch.zeros((b, hq, tq, d), dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, tk, block_k):
        kj = k[:, :, k0:k0 + block_k].float()
        vj = v[:, :, k0:k0 + block_k].float()
        kjr, vjr = kj.repeat_interleave(group, dim=1), vj.repeat_interleave(group, dim=1)
        s = torch.einsum("bhqd,bhkd->bhqk", qf, kjr) * scale
        k_pos = k0 + torch.arange(kj.shape[2], device=q.device)[None, :]
        live = torch.ones((tq, kj.shape[2]), dtype=torch.bool, device=q.device)
        if causal:
            live = live & (k_pos <= q_pos)
        if window is not None:
            live = live & (k_pos > q_pos - window)
        p = torch.where(live, torch.exp(s - lse[..., None]), torch.zeros_like(s))
        dv_r = torch.einsum("bhqk,bhqd->bhkd", p, do)
        dp = torch.einsum("bhqd,bhkd->bhqk", do, vjr)
        ds = p * (dp - delta) * scale
        dq = dq + torch.einsum("bhqk,bhkd->bhqd", ds, kjr)
        dk_r = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
        n = kj.shape[2]
        dks.append(dk_r.reshape(b, hkv, group, n, d).sum(dim=2))
        dvs.append(dv_r.reshape(b, hkv, group, n, d).sum(dim=2))
    return (dq.to(q.dtype), torch.cat(dks, dim=2).to(k.dtype),
            torch.cat(dvs, dim=2).to(v.dtype))


flash_bwd_torch.calls = 0


def flash_bwd_split_torch(q, k, v, out, dout, lse, *, causal: bool = True,
                          window: Optional[int] = None, q_offset: int = 0,
                          scale: Optional[float] = None, splits: int = 1):
    """The plain twin of the bf16 kernels' dK/dV schedule -> (dq, dk, dv) in
    the inputs' dtypes: each key tile's walk (``kv_walk``: item g x n + i is
    query tile i of group member g) cut into ``splits`` (``split_range``),
    each split's partial summed over its items in walk order (dK's times
    scale), the partials folded in split order, rounded once; dq is
    ``flash_bwd_torch``'s. ``q_offset`` an int."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    t = tiles(d, torch.bfloat16)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    off = int(q_offset)
    qf = q.float().reshape(b, hkv, group, tq, d)
    do = dout.float().reshape(b, hkv, group, tq, d)
    delta = (dout.float() * out.float()).sum(dim=-1).reshape(b, hkv, group, tq)
    lse_g = lse.reshape(b, hkv, group, tq)
    dk = torch.zeros((b, hkv, tk, d), dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for j0 in range(0, tk, t.kv_keys):
        kj, vj = k[:, :, j0:j0 + t.kv_keys].float(), v[:, :, j0:j0 + t.kv_keys].float()
        k_pos = j0 + torch.arange(kj.shape[2], device=q.device)[:, None]
        t_lo, n_qt = kv_walk(j0, tq, tk, off, causal, window, t.kv_rows, t.kv_keys)
        acc_k = acc_v = None
        for s in range(splits):
            part_k, part_v = torch.zeros_like(kj), torch.zeros_like(vj)
            for item in range(*split_range(group * n_qt, splits, s)):
                g, i = divmod(item, n_qt)
                t0 = t_lo + i * t.kv_rows
                t1 = min(t0 + t.kv_rows, tq)
                qs, dos = qf[:, :, g, t0:t1], do[:, :, g, t0:t1]
                q_pos = off + torch.arange(t0, t1, device=q.device)[None, :]
                live = torch.ones((kj.shape[2], t1 - t0), dtype=torch.bool, device=q.device)
                if causal:
                    live = live & (k_pos <= q_pos)
                if window is not None:
                    live = live & (k_pos > q_pos - window)
                st = torch.einsum("bhkd,bhqd->bhkq", kj, qs) * scale
                p = torch.where(live, torch.exp(st - lse_g[:, :, g, None, t0:t1]),
                                torch.zeros_like(st))
                dpt = torch.einsum("bhkd,bhqd->bhkq", vj, dos)
                ds = torch.where(live, p * (dpt - delta[:, :, g, None, t0:t1]),
                                 torch.zeros_like(st))
                part_v = part_v + torch.einsum("bhkq,bhqd->bhkd", p, dos)
                part_k = part_k + torch.einsum("bhkq,bhqd->bhkd", ds, qs)
            part_k = part_k * scale
            acc_k = part_k if acc_k is None else acc_k + part_k
            acc_v = part_v if acc_v is None else acc_v + part_v
        dk[:, :, j0:j0 + kj.shape[2]] = acc_k
        dv[:, :, j0:j0 + kj.shape[2]] = acc_v
    dq = flash_bwd_torch(q, k, v, out, dout, lse, causal=causal, window=window, q_offset=off,
                         scale=scale)[0]
    return dq, dk.to(k.dtype), dv.to(v.dtype)


class _FlashTorch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale, block_k):
        out, lse = attention_torch(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                   scale=scale, block_k=block_k, return_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset, scale=scale,
                        block_k=block_k)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd_torch(q, k, v, out, dout, lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None, None


def flash_attention_torch(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                          q_offset=0, scale: Optional[float] = None,
                          block_k: int = 512) -> torch.Tensor:
    """The plain differentiable attention (``flash_attention_jnp``): forward
    ``attention_torch``, backward ``flash_bwd_torch``, on any device. Its
    calls are counted in ``.calls``."""
    flash_attention_torch.calls += 1
    return _FlashTorch.apply(q, k, v, causal, window, q_offset, scale, block_k)


flash_attention_torch.calls = 0


# ---------------------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------------------
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = _build.Binding("flash_attention_bwd", {
    "repro_flash_attention_bwd": [_i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _p, _i,
                                  _i, _i, _i, _i, _i, _i, _i, _i, _i, _f, _p],
    "repro_flash_bwd_blocks_per_sm": [_i, ctypes.POINTER(_i)],  # no stream
}, geometry=GEOMETRY)


@functools.lru_cache(maxsize=16)
def blocks_per_sm(d: int, device: torch.device) -> int:
    """bf16 dK/dV blocks at head dim ``d`` that fit on one SM of ``device``
    at once, registers and shared memory included (the library's occupancy
    query), asked once each."""
    out = _i(0)
    with torch.cuda.device(device):
        rc = _LIB.lib().repro_flash_bwd_blocks_per_sm(d, ctypes.byref(out))
    if rc != 0:
        msg = _LIB.lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"flash_attention_bwd occupancy query failed: CUDA error {rc} ({msg})")
    return out.value


def plan_for(q, k) -> BwdPlan:
    """``bwd_plan`` for CUDA tensors q, k on their card."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    per_sm = blocks_per_sm(d, q.device) if q.dtype == torch.bfloat16 else 1
    return bwd_plan(b, hq, hkv, tq, tk, d, q.dtype, sm_count(q.device), per_sm)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: Optional[int] = None, q_offset=0,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of flash attention from the forward's (q, k, v, out, lse)
    and the output's gradient ``dout`` (csrc/flash_attention_bwd.cu: bf16 on
    the tensor cores, its dK/dV walk split as ``bwd_plan`` says; f32 on the
    CUDA cores). On CUDA: q, k, v, out, dout contiguous in one of
    float32/bfloat16 (bfloat16 on 16-byte boundaries), D in HEAD_DIMS, lse a
    contiguous f32 (B, Hq, Tq) tensor. Gradients in the inputs' dtype."""
    if q.device.type == "cpu":
        return flash_bwd_torch(q, k, v, out, dout, lse, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
    _check_qkv(q, k, v)
    return _bwd_cuda(q, k, v, out, dout, lse, causal, window, q_offset, scale,
                     plan_for(q, k).splits)


def _bwd_cuda(q, k, v, out, dout, lse, causal, window, q_offset, scale, splits: int):
    """The launch of ``flash_attention_bwd`` with ``splits`` pieces of each
    key tile's dK/dV walk (1 for f32) on q, k, v that ``_check_qkv``
    passed."""
    for name, t in (("out", out), ("dout", dout)):
        _check(name, t, ndim=4, dtype=q.dtype, device=q.device)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    _check("lse", lse, ndim=3, dtype=torch.float32, device=q.device)
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse {tuple(lse.shape)} must be {tuple(q.shape[:3])}")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v), ("out", out), ("dout", dout)):
            if t.data_ptr() % 16:
                raise ValueError(f"{name} must start on a 16-byte boundary")
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    off_t, off = _offset(q_offset, q.device)
    has_w, w = _window(window)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    ws = (torch.empty((2, splits, b, hkv, tk, d), dtype=torch.float32, device=q.device)
          if splits > 1 else None)
    _LIB.launch(
        "repro_flash_attention_bwd", "flash_attention_bwd",
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ws.data_ptr() if ws is not None else None, splits,
        off_t.data_ptr() if off_t is not None else None, off, b, hq, hkv, tq, tk, d,
        int(bool(causal)), has_w, w, scale, device=q.device,
    )
    flash_attention_bwd.launches += 1
    return dq, dk, dv


flash_attention_bwd.launches = 0


class FlashAttentionFn(torch.autograd.Function):
    """Flash attention on the card with a gradient: forward on
    ``flash_attention``'s kernel (which also writes lse), backward on
    ``flash_attention_bwd``'s; saves only (q, k, v, out, lse)."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, scale):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                              scale=scale, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.opts = dict(causal=causal, window=window, q_offset=q_offset, scale=scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, dout.contiguous(), lse, **ctx.opts)
        return dq, dk, dv, None, None, None, None


KERNEL_WRAPPERS = {"flash_attention_bwd": flash_attention_bwd}
