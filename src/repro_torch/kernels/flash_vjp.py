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
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional

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

# csrc/flash_attention_bwd.cu's kGeometry, in its order: threads a block, query
# rows and keys a tile up to D 128, and at D 256; the library is checked
# against it when it loads
GEOMETRY = {"threads": 256, "rows": 64, "keys": 64, "rows_d256": 32, "keys_d256": 32}


def tiles(d: int):
    """(query rows, keys) a tile of the backward kernels at head dim ``d``."""
    if d > 128:
        return GEOMETRY["rows_d256"], GEOMETRY["keys_d256"]
    return GEOMETRY["rows"], GEOMETRY["keys"]


def grid_blocks(b: int, hq: int, hkv: int, tq: int, tk: int, d: int):
    """(dK/dV blocks, dQ blocks) of one backward launch."""
    rows, keys = tiles(d)
    return cdiv(tk, keys) * hkv * b, cdiv(tq, rows) * hq * b


# ---------------------------------------------------------------------------------
# plain PyTorch backward
# ---------------------------------------------------------------------------------
def flash_bwd_torch(q, k, v, out, dout, lse, *, causal: bool = True,
                    window: Optional[int] = None, q_offset=0, scale: Optional[float] = None,
                    block_k: int = 512):
    """The reference's ``_bwd`` over key blocks of ``block_k``: -> (dq, dk,
    dv) in the inputs' dtypes. P is recomputed from ``lse`` and zeroed on dead
    pairs by liveness (a fully masked row has lse NEG_INF and zero
    gradients); GQA folds each kv head's group of query heads back onto it."""
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
    ``attention_torch``, backward ``flash_bwd_torch``, on any device."""
    return _FlashTorch.apply(q, k, v, causal, window, q_offset, scale, block_k)


# ---------------------------------------------------------------------------------
# CUDA
# ---------------------------------------------------------------------------------
_p, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_LIB = _build.Binding("flash_attention_bwd", {
    "repro_flash_attention_bwd": [_i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i,
                                  _i, _i, _i, _i, _i, _i, _i, _f, _p],
}, geometry=GEOMETRY)


def flash_attention_bwd(q, k, v, out, dout, lse, *, causal: bool = True,
                        window: Optional[int] = None, q_offset=0,
                        scale: Optional[float] = None):
    """(dq, dk, dv) of flash attention from the forward's (q, k, v, out, lse)
    and the output's gradient ``dout`` (kernels: a delta pass, the dK/dV
    kernel and the dQ kernel of csrc/flash_attention_bwd.cu, f32 sums on the
    CUDA cores). On CUDA: q, k, v, out, dout contiguous in one of
    float32/bfloat16, D in HEAD_DIMS, lse a contiguous f32 (B, Hq, Tq)
    tensor. Gradients in the inputs' dtype."""
    if q.device.type == "cpu":
        return flash_bwd_torch(q, k, v, out, dout, lse, causal=causal, window=window,
                               q_offset=q_offset, scale=scale)
    _check_qkv(q, k, v)
    for name, t in (("out", out), ("dout", dout)):
        _check(name, t, ndim=4, dtype=q.dtype, device=q.device)
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} != q {tuple(q.shape)}")
    _check("lse", lse, ndim=3, dtype=torch.float32, device=q.device)
    if tuple(lse.shape) != tuple(q.shape[:3]):
        raise ValueError(f"lse {tuple(lse.shape)} must be {tuple(q.shape[:3])}")
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    off_t, off = _offset(q_offset, q.device)
    has_w, w = _window(window)
    scale = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    delta = torch.empty_like(lse)
    _LIB.launch(
        "repro_flash_attention_bwd", "flash_attention_bwd",
        _DTYPE_CODE[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        dout.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), off_t.data_ptr() if off_t is not None else None, off, b, hq, hkv, tq,
        tk, d, int(bool(causal)), has_w, w, scale, device=q.device,
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
