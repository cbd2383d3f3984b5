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


def _gated_out(cfg, p, y: torch.Tensor, xh: torch.Tensor, z: torch.Tensor, lm=None,
               split: bool = False) -> torch.Tensor:
    """The skip term in y's dtype, then mamba2's RMSNormGated (normalize the
    GATED value) and the out projection; y / xh (..., H, P), z (..., Di).
    Split over "model" (``split``, inside a block map: the rank's heads) the
    norm's mean of squares is the sum over "model" of each rank's over
    its columns, divided by the whole width, and the out projection is
    row-parallel, summed over "model"."""
    y = y + xh.float().to(y.dtype) * p["D_skip"].to(y.dtype)[:, None]
    y = y.reshape(*y.shape[:-2], y.shape[-2] * y.shape[-1])
    g = y * F.silu(z.float()).to(y.dtype)
    if not split:
        return torch.matmul(apply_rmsnorm(g, p["norm"]), p["out_proj"].to(y.dtype))
    gf = g.float()
    var = lm.sum_both(torch.sum(gf * gf, dim=-1, keepdim=True)) / cfg.ssm_dinner
    g = (gf * torch.rsqrt(var + 1e-6) * p["norm"]).to(y.dtype)
    return lm.sum(torch.matmul(g, p["out_proj"].to(y.dtype)))


def split_columns(cfg, h_loc: int, rank: int, device):
    """The columns of the fused in_proj (z | x | B | C | dt) and of the fused
    conv (x | B | C) that a rank with heads rank * h_loc .. + h_loc reads:
    its heads' z, x and dt, and B and C whole (ngroups 1: every head reads
    them)."""
    di, gn, hd = cfg.ssm_dinner, cfg.ssm_ngroups * cfg.ssm_state, cfg.ssm_headdim
    lo, w = rank * h_loc * hd, h_loc * hd

    def run(a, n):
        return torch.arange(a, a + n, device=device)

    proj = torch.cat([run(lo, w), run(di + lo, w), run(2 * di, 2 * gn),
                      run(2 * di + 2 * gn + rank * h_loc, h_loc)])
    conv = torch.cat([run(lo, w), run(di, 2 * gn)])
    return proj, conv


def apply_ssm(cfg, p, x: torch.Tensor, *, lm=None, initial_state=None,
              return_state: bool = False, impl: str = "auto"):
    """x (B, S, D) -> y (B, S, D) [+ the decode cache {"state", "conv"}].
    ``impl`` picks the SSD scan (kernels.ops.ssd).

    Inside a block map (``lm``) with the heads split over "model" (the
    local ``A_log`` shorter than the heads): the fused in_proj, conv_w and
    conv_b come in whole (their columns cut across z | x | B | C | dt), x
    enters the split block, and the rank reads its heads' z, x and dt
    columns and B and C whole (``split_columns``), runs the conv and
    ``ops.ssd`` on its heads, the norm with its sum over "model" and the
    row-parallel out projection (``_gated_out``). B's and C's gradients are
    each rank's part, summed over "model" with in_proj's. With
    ``return_state`` (the serving prefill) the cache comes out whole on
    "model": the heads' final states gathered, the conv tail's pre-conv xBC
    rows from the whole in_proj (``initial_state`` is the rank's heads')."""
    b, s, _ = x.shape
    di, g, n, h, hd = (cfg.ssm_dinner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                       cfg.ssm_headdim)
    h_loc = p["A_log"].shape[0]
    split = lm is not None and lm.model is not None and h_loc < h
    if split:
        if g != 1:
            raise NotImplementedError("a head-split SSM block runs at ngroups 1 (every head "
                                      "reads the one group's B and C)")
        proj, conv = split_columns(cfg, h_loc, lm.model_rank, x.device)
        x = lm.enter(x)
        zxbcdt = torch.matmul(x, p["in_proj"].index_select(1, proj).to(x.dtype))
        z, xbc, dtp = (zxbcdt[..., :h_loc * hd], zxbcdt[..., h_loc * hd:-h_loc],
                       zxbcdt[..., -h_loc:])
        conv_w, conv_b = p["conv_w"].index_select(1, conv), p["conv_b"].index_select(0, conv)
    else:
        zxbcdt = torch.matmul(x, p["in_proj"].to(x.dtype))
        z, xbc, dtp = _split_proj(cfg, zxbcdt)
        conv_w, conv_b = p["conv_w"], p["conv_b"]
    xbc = _causal_conv(xbc, conv_w, conv_b)
    xbc = F.silu(xbc.float()).to(x.dtype)
    dl = h_loc * hd
    xh = xbc[..., :dl].reshape(b, s, h_loc, hd).contiguous()
    Bm = xbc[..., dl:dl + g * n].reshape(b, s, g, n).contiguous()
    Cm = xbc[..., dl + g * n:].reshape(b, s, g, n).contiguous()
    dt = F.softplus(dtp.float() + p["dt_bias"])  # (B, S, H)
    A = -torch.exp(p["A_log"])  # (H,)
    chunk = min(cfg.ssm_chunk, s)
    if s % chunk:
        chunk = s
    y, state = ops.ssd(xh, dt, A, Bm, Cm, chunk=chunk, initial_state=initial_state,
                       return_final_state=True, impl=impl)
    out = _gated_out(cfg, p, y, xh, z, lm, split)
    if not return_state:
        return out
    if split:
        k = cfg.conv_kernel
        xbc_cols = p["in_proj"][:, di:2 * di + 2 * g * n].to(x.dtype)
        tail = conv_tail(torch.matmul(x[:, -(k - 1):], xbc_cols), k)
        return out, {"state": lm.gather(state.contiguous(), 1), "conv": tail}
    return out, {"state": state, "conv": xbc_raw_tail(cfg, x, p, zxbcdt)}


def ssm_whole(p, prefix: str = "") -> set:
    """The leaves of DTensor SSM weights ``p`` a block map takes whole on
    "model": the fused in_proj and conv, whose columns cut across the parts,
    and, where the heads are not split, every leaf (each rank then runs the
    whole block)."""
    from repro_torch.core.distributed import is_split

    if is_split(p["A_log"], 0):
        return {prefix + k for k in ("in_proj", "conv_w", "conv_b")}
    return {prefix + k for k in p}


def ssm_partial(p, prefix: str = "") -> set:
    """The leaves whose gradient each model rank holds a part of: the fused
    in_proj and conv where the heads are split (B's and C's columns take
    every rank's heads' part; the others are the rank's own)."""
    from repro_torch.core.distributed import is_split

    return ssm_whole(p, prefix) if is_split(p["A_log"], 0) else set()


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


def apply_ssm_decode(cfg, p, x: torch.Tensor, cache, pos, lm=None):
    """x (B, 1, D); cache {"state": (B, H, P, N) f32, "conv": (B, K - 1,
    conv_dim)} -> (y (B, 1, D), the new cache as fresh tensors).

    Inside a serving block map (``lm``): the fused in_proj and conv come in
    whole (``ssm_whole``), so the new xBC row and the conv run on every
    column, over the conv cache gathered whole where ``serve_rules`` split
    it ("ssm_conv"); with the heads split the state update, the gated norm
    (its sum over "model") and the row-parallel out projection run on the
    rank's heads, whose state the cache holds ("ssm_heads"). The new conv
    cache is the rank's columns of the whole one."""
    b = x.shape[0]
    di, g, n, h, hd = (cfg.ssm_dinner, cfg.ssm_ngroups, cfg.ssm_state, cfg.ssm_nheads,
                       cfg.ssm_headdim)
    h_loc = p["A_log"].shape[0]
    split = lm is not None and lm.model is not None and h_loc < h
    if split:
        x = lm.enter(x)
    zxbcdt = torch.matmul(x[:, 0], p["in_proj"].to(x.dtype))  # (B, ...)
    z, xbc_new, dtp = _split_proj(cfg, zxbcdt)
    k = cfg.conv_kernel
    w = p["conv_w"]
    c_loc = cache["conv"].shape[2]
    past = cache["conv"] if c_loc == cfg.ssm_conv_dim else lm.gather(cache["conv"], 2)
    # conv over [cache, new]: b + w[k-1] * new + sum_{i < k-1} w[i] * cache[i]
    conv = p["conv_b"].float() + xbc_new.float() * w[k - 1].float()
    for i in range(k - 1):
        conv = conv + past[:, i].float() * w[i].float()
    new_conv = torch.cat([past[:, 1:], xbc_new[:, None].to(past.dtype)], dim=1)
    if c_loc < cfg.ssm_conv_dim:
        new_conv = new_conv[..., lm.model_rank * c_loc:(lm.model_rank + 1) * c_loc]
    xbc = F.silu(conv).to(x.dtype)
    xh = xbc[..., :di].reshape(b, h, hd)
    Bm = xbc[..., di:di + g * n].reshape(b, g, n)
    Cm = xbc[..., di + g * n:].reshape(b, g, n)
    if split:
        r = lm.model_rank
        xh, dtp = xh[:, r * h_loc:(r + 1) * h_loc], dtp[:, r * h_loc:(r + 1) * h_loc]
        z = z[:, r * h_loc * hd:(r + 1) * h_loc * hd]
    dt = F.softplus(dtp.float() + p["dt_bias"])  # (B, H)
    A = -torch.exp(p["A_log"])
    state, y = ops.ssd_decode_step(cache["state"], xh, dt, A, Bm, Cm)
    out = _gated_out(cfg, p, y, xh, z, lm, split)[:, None, :]
    return out, {"state": state, "conv": new_conv}
