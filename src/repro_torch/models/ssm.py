"""Mamba-2 block (SSD) of the port: fused in-proj -> causal conv -> SSD scan
-> gated norm -> out-proj.

Port of ``repro.models.ssm``. Prefill and training run the chunked SSD scan
through ``kernels.ops.ssd`` (the ssd_scan kernel on CUDA tensors, ngroups 1,
and under grad ``ssd_scan.SSDScanFn``, its backward on the ssd_scan_bwd
kernels; the reference pins its jnp twin here), fed as the kernels take it:
x, B, C contiguous in the compute dtype, dt and A f32 (fresh, contiguous
tensors); decode is an O(1)-per-token state update
(``ops.ssd_decode_step``, plain PyTorch as in the reference). The casts
follow the reference's order, bf16 skip term and gated RMSNorm included.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import ParamSpec, apply_rmsnorm


def ssm_specs(cfg, *, quant=None) -> Dict[str, ParamSpec]:
    """One block's parameters; ``quant`` is accepted and unused, as in the
    reference (only the MLP is stored quantized)."""
    d, di = cfg.d_model, cfg.ssm_dinner
    g, n, h = cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads
    conv_dim = cfg.ssm_conv_dim
    dt = cfg.param_dtype
    d_in_proj = 2 * di + 2 * g * n + h  # z, x, B, C, dt
    return {
        "in_proj": ParamSpec((d, d_in_proj), dt, logical_axes=("embed", "ssm_inner")),
        "conv_w": ParamSpec((cfg.conv_kernel, conv_dim), dt, "fan_in",
                            logical_axes=(None, "ssm_conv")),
        "conv_b": ParamSpec((conv_dim,), torch.float32, "zeros", logical_axes=("ssm_conv",)),
        "A_log": ParamSpec((h,), torch.float32, "zeros", logical_axes=("ssm_heads",)),
        "D_skip": ParamSpec((h,), torch.float32, "ones", logical_axes=("ssm_heads",)),
        "dt_bias": ParamSpec((h,), torch.float32, "zeros", logical_axes=("ssm_heads",)),
        "norm": ParamSpec((di,), torch.float32, "ones", logical_axes=("ssm_inner",)),
        "out_proj": ParamSpec((di, d), dt, logical_axes=("ssm_inner", "embed")),
    }


def ssm_cache_specs(cfg, batch: int) -> Dict[str, ParamSpec]:
    """The decode state: the (B, H, P, N) f32 SSM state and the last K - 1
    pre-conv xBC rows."""
    h, p, n = cfg.ssm_nheads, cfg.ssm_headdim, cfg.ssm_state
    return {
        "state": ParamSpec((batch, h, p, n), torch.float32, "zeros",
                           logical_axes=("batch", "ssm_heads", None, None)),
        "conv": ParamSpec((batch, cfg.conv_kernel - 1, cfg.ssm_conv_dim), cfg.param_dtype,
                          "zeros", logical_axes=("batch", None, "ssm_conv")),
    }


def _split_proj(cfg, zxbcdt: torch.Tensor):
    di = cfg.ssm_dinner
    g, n = cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, xbc, dt


def _causal_conv(xbc: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv, kernel K: y_t = b + sum_i w[i] * x_{t-K+1+i}."""
    k, s = w.shape[0], xbc.shape[1]
    acc = torch.zeros(xbc.shape, dtype=torch.float32, device=xbc.device)
    for i in range(k):
        shift = k - 1 - i
        xi = F.pad(xbc, (0, 0, shift, 0))[:, :s, :]
        acc = acc + xi.float() * w[i].float()
    return (acc + b).to(xbc.dtype)


def _gated_out(cfg, p, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor) -> torch.Tensor:
    """The skip term in y's dtype, then mamba2's RMSNormGated (normalize the
    GATED value) and the out projection; y / xh (..., H, P), z (..., Di)."""
    y = y + xh.float().to(y.dtype) * p["D_skip"].to(y.dtype)[:, None]
    y = y.reshape(*y.shape[:-2], cfg.ssm_dinner)
    y = apply_rmsnorm(y * F.silu(z.float()).to(y.dtype), p["norm"])
    return torch.matmul(y, p["out_proj"].to(y.dtype))


def apply_ssm(cfg, p, x: torch.Tensor, *, initial_state=None, return_state: bool = False,
              impl: str = "auto"):
    """x (B, S, D) -> y (B, S, D) [+ the decode cache {"state", "conv"}].
    ``impl`` picks the SSD scan (kernels.ops.ssd)."""
    b, s, _ = x.shape
    di, g, n, h, hd = (cfg.ssm_dinner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                       cfg.ssm_headdim)
    zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
    z, xbc, dtp = _split_proj(cfg, zxbcdt)
    xbc = _causal_conv(xbc, p["conv_w"], p["conv_b"])
    xbc = F.silu(xbc.float()).to(x.dtype)
    xh = xbc[..., :di].reshape(b, s, h, hd).contiguous()
    Bm = xbc[..., di:di + g * n].reshape(b, s, g, n).contiguous()
    Cm = xbc[..., di + g * n:].reshape(b, s, g, n).contiguous()
    dt = F.softplus(dtp.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,)
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = s
    y, state = ops.ssd(xh, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state,
                       return_final_state=True, impl=impl)
    out = _gated_out(cfg, p, y, xh, z)
    if return_state:
        return out, {"state": state, "conv": xbc_raw_tail(cfg, x, p, zxbcdt)}
    return out


def conv_tail(x_raw: torch.Tensor, k: int) -> torch.Tensor:
    """The last K - 1 PRE-conv rows of x_raw (B, S, C): the conv state carried
    into decode. A prompt shorter than K - 1 is left-padded with the zeros the
    causal conv reads before the sequence start (the reference keeps fewer
    rows there: ROADMAP Queue 3)."""
    tail = x_raw[:, -(k - 1):, :]
    if tail.shape[1] < k - 1:
        tail = F.pad(tail, (0, 0, k - 1 - tail.shape[1], 0))
    return tail


def xbc_raw_tail(cfg, x, p, zxbcdt: torch.Tensor) -> torch.Tensor:
    """The last K - 1 pre-conv xBC rows (conv_tail)."""
    _, xbc_raw, _ = _split_proj(cfg, zxbcdt)
    return conv_tail(xbc_raw, cfg.conv_kernel)


def apply_ssm_decode(cfg, p, x: torch.Tensor, cache, pos):
    """x (B, 1, D); cache {"state": (B, H, P, N) f32, "conv": (B, K - 1,
    conv_dim)} -> (y (B, 1, D), the new cache as fresh tensors)."""
    b = x.shape[0]
    di, g, n, h, hd = (cfg.ssm_dinner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                       cfg.ssm_headdim)
    zxbcdt = torch.matmul(x[:, 0], p["in_proj"].to(x.dtype))  # (B, ...)
    z, xbc_new, dtp = _split_proj(cfg, zxbcdt)
    k = cfg.conv_kernel
    w = p["conv_w"]
    # conv over [cache, new]: b + w[k-1] * new + sum_{i < k-1} w[i] * cache[i]
    conv = p["conv_b"].float() + xbc_new.float() * w[k - 1].float()
    for i in range(k - 1):
        conv = conv + cache["conv"][:, i].float() * w[i].float()
    new_conv = torch.cat([cache["conv"][:, 1:], xbc_new[:, None].to(cache["conv"].dtype)], dim=1)
    xbc = F.silu(conv).to(x.dtype)
    xh = xbc[..., :di].reshape(b, h, hd)
    Bm = xbc[..., di:di + g * n].reshape(b, g, n)
    Cm = xbc[..., di + g * n:].reshape(b, g, n)
    dt = F.softplus(dtp.float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    state, y = ops.ssd_decode_step(cache["state"], xh, dt, A, Bm, Cm)
    out = _gated_out(cfg, p, y, xh, z)[:, None, :]
    return out, {"state": state, "conv": new_conv}
