"""Mamba-2 SSD (state-space duality) chunked scan: the plain PyTorch version
and the wrapper that launches the hand-written CUDA kernel.

Port of ``repro.kernels.ssd_scan`` and of the reference's chunked jnp twin:

  ssd_torch      <- ops.ssd_jnp (the chunked twin, any ngroups)
  ssd_scan       <- ssd_scan (Pallas, ngroups 1) — launches
                    csrc/ssd_scan.cu::cb_kernel (C . B once per sequence and
                    chunk, into a workspace) then ::ssd_kernel (the scan)
  ssd_bwd_torch  <- the gradient of ops.ssd_jnp, which the reference takes by
                    autodiff: its plain twin, the chunked dual of the forward
  ssd_scan_bwd   <- the same gradient (ngroups 1) — launches
                    csrc/ssd_scan_bwd.cu's kernels: one launch for the
                    state and adjoint passes, the two chunk kernels of a
                    (head group, chunk, sequence), the folds
  SSDScanFn      the autograd Function the card trains through: ssd_scan
                    forward, ssd_scan_bwd backward

Per head h, with a_t = exp(dt_t * A_h): S_t = a_t S_{t-1} + dt_t x_t B_t^T and
y_t = C_t . S_t, computed chunk by chunk (an intra-chunk masked product plus
the carried state). x (b, t, h, p); dt (b, t, h) positive step sizes; A (h,)
negative; B / C (b, t, g, n) with h % g == 0; an optional f32 initial state
(b, h, p, n). Returns y in x's dtype [and the f32 final state].

Chunk length: the plain version chunks by ``chunk`` as the reference does,
and where t is no multiple of it pads the tail with dt = 0, x = 0 (exact: a
padded step decays nothing and adds nothing; the reference asserts instead).
The kernel walks its own 64-step chunks whatever ``chunk`` says and masks a
ragged tail the same way, so it tiles the chunk = t case of a ragged prompt
(``models.ssm.apply_ssm``) at a fixed 64 x 64 product; the two differ in
rounding only.

On CPU tensors the wrappers return the plain versions; on CUDA tensors they
launch the kernels or raise. Their calls are counted in ``.launches``: one a
call, the kernels of a C entry together. ``ssd_scan`` has no backward of its
own (it raises under grad on the card); a gradient goes through SSDScanFn.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .common import no_dtensor, no_grad_through

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 256  # n_state the kernel's shared-memory tiles hold at most
# csrc/ssd_scan.cu's kGeometry, in its order; the library is checked against
# it when it loads: the kernel's chunk (the C . B workspace's tile), the
# columns of P a block takes and its threads.
GEOMETRY = {"chunk": 64, "p_slice": 32, "threads": 256}


# ---------------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------------
def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The plain versions' working type: f32, or f64 for f64 inputs (the
    gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def ssd_torch(x, dt, A, B, C, *, chunk: int = 64, initial_state=None,
              return_final_state: bool = False):
    """Chunked SSD, the reference's ``ssd_jnp``: f32 throughout (f64 for f64
    inputs), a loop over chunks carrying the (b, h, p, n) state. Its calls
    are counted in ``.calls``."""
    ssd_torch.calls += 1
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    acc = _acc_dtype(x)
    pad = -t % chunk
    if pad:  # dt = 0, x = 0 steps leave y and the state unchanged
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad))
    tp = t + pad
    nc = tp // chunk
    xf = x.to(acc).reshape(b, nc, chunk, h, p)
    dtf = dt.to(acc).reshape(b, nc, chunk, h)
    Bf = B.to(acc).repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    Cf = C.to(acc).repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    Af = A.to(acc)
    tri = torch.tril(torch.ones((chunk, chunk), dtype=acc, device=x.device))
    S = (torch.zeros((b, h, p, n), dtype=acc, device=x.device)
         if initial_state is None else initial_state.to(acc))
    ys = []
    for c in range(nc):
        xq, dtq, Bq, Cq = xf[:, c], dtf[:, c], Bf[:, c], Cf[:, c]
        s = torch.cumsum(dtq * Af[None, None, :], dim=1)  # (b, Q, h)
        y_inter = torch.einsum("bqhn,bhpn->bqhp", Cq, S) * torch.exp(s)[..., None]
        cb = torch.einsum("bqhn,buhn->bhqu", Cq, Bq)
        seg = (s[:, :, None, :] - s[:, None, :, :]).permute(0, 3, 1, 2)  # (b, h, t, u)
        m = (cb * torch.exp(torch.clamp(seg, max=0.0))
             * dtq.transpose(1, 2)[:, :, None, :] * tri[None, None])
        y_intra = torch.einsum("bhtu,buhp->bthp", m, xq)
        w = torch.exp(s[:, -1:, :] - s) * dtq  # (b, Q, h)
        upd = torch.einsum("bqhp,bqhn->bhpn", xq * w[..., None], Bq)
        S = S * torch.exp(s[:, -1])[:, :, None, None] + upd
        ys.append((y_inter + y_intra).to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(b, tp, h, p)[:, :t]
    if return_final_state:
        return y, S
    return y


ssd_torch.calls = 0


def _fold(parts: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum ``parts`` over ``dim`` one slice after another, in index order: the
    backward kernels' folds (the heads of a group in order in
    csrc/ssd_scan_bwd.cu's chunk kernels, the groups in order in its
    fold_kernel, the (sequence, chunk) partials of dA in its fold_da_kernel),
    so the bits follow that order."""
    out = parts.select(dim, 0).clone()
    for i in range(1, parts.shape[dim]):
        out = out + parts.select(dim, i)
    return out


def ssd_bwd_torch(x, dt, A, B, C, dy, *, initial_state=None, d_final_state=None,
                  chunk: int = 64):
    """The gradient of ``ssd_torch`` (y and the final state) written out as
    the chunked dual of the forward: the plain twin of ssd_scan_bwd's
    kernels, chunk for chunk. dy (b, t, h, p) or None, ``d_final_state``
    (b, h, p, n) or None. -> (dx, ddt, dA, dB, dC, d_initial_state): dx in
    x's dtype, dB / dC in B's, the rest in f32 (f64 for f64 inputs);
    d_initial_state None without an initial state.

    Per chunk, with s the running sum of dt * A inside it, e_t = exp(s_t),
    w_u = exp(s_Q - s_u) dt_u, L[t, u] = exp(s_t - s_u) (u <= t) and CB =
    C . B^T:
      1. the chunk-start states S_c, by the forward's carry (a state pass);
      2. the state adjoints, a reverse pass over chunks: Lam_c, the adjoint
         of the state leaving chunk c, starts at d_final_state and
         Lam_{c-1} = exp(s_Q) Lam_c + G_c with G_c = sum_t e_t dy_t C_t^T;
         what is left after chunk 0 is d_initial_state;
      3. per chunk: dM = dy . x^T, M = CB o L o dt, dCB = dM o L o dt,
         dx = M^T dy + w o (B . Lam^T),
         dC = e o (dy . S_c) + dCB . B,  dB = w o (x . Lam) + dCB^T . C
         (the terms of a head group's heads folded in head order, the dCB
         term of the group's summed dCB added after them, then the groups
         folded in order: ``bwd_head_groups``),
         the log-decay adjoint ds (from e, from L through Z = dM o M, from
         exp(s_Q) and w), its reverse cumsum r inside the chunk, ddt = the
         direct terms + A r, and dA = sum dt r per (sequence, chunk), folded
         over sequences and chunks in order.
    Padded tail steps (t no multiple of ``chunk``) are dt = x = B = C = dy =
    0 and add nothing. Its calls are counted in ``.calls``."""
    ssd_bwd_torch.calls += 1
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    acc = _acc_dtype(x)
    dev = x.device
    if dy is None:
        dy = torch.zeros_like(x)
    pad = -t % chunk
    if pad:
        x, dy = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dy, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad))
    nc, q = (t + pad) // chunk, chunk
    xf = x.to(acc).reshape(b, nc, q, h, p)
    dyf = dy.to(acc).reshape(b, nc, q, h, p)
    dtf = dt.to(acc).reshape(b, nc, q, h)
    Bf = B.to(acc).repeat_interleave(rep, dim=2).reshape(b, nc, q, h, n)
    Cf = C.to(acc).repeat_interleave(rep, dim=2).reshape(b, nc, q, h, n)
    Af = A.to(acc)
    s = torch.cumsum(dtf * Af, dim=2)  # (b, nc, Q, h)
    last = s[:, :, -1]  # (b, nc, h)
    e = torch.exp(s)
    decay = torch.exp(last)
    w = torch.exp(last[:, :, None] - s) * dtf
    # 1. the chunk-start states
    S = (torch.zeros((b, h, p, n), dtype=acc, device=dev) if initial_state is None
         else initial_state.to(acc))
    starts = []
    for c in range(nc):
        starts.append(S)
        S = (S * decay[:, c, :, None, None]
             + torch.einsum("bqhp,bqhn->bhpn", xf[:, c] * w[:, c, ..., None], Bf[:, c]))
    S0 = torch.stack(starts, dim=1)  # (b, nc, h, p, n)
    # 2. the state adjoints, chunk by chunk in reverse
    lam = (torch.zeros((b, h, p, n), dtype=acc, device=dev) if d_final_state is None
           else d_final_state.to(acc))
    lams = [None] * nc
    for c in reversed(range(nc)):
        lams[c] = lam
        lam = (lam * decay[:, c, :, None, None]
               + torch.einsum("bqhp,bqhn->bhpn", dyf[:, c] * e[:, c, ..., None], Cf[:, c]))
    d_init = lam if initial_state is not None else None
    Lam = torch.stack(lams, dim=1)  # (b, nc, h, p, n)
    # 3. the chunk-local products, every chunk at once: (b, nc, h, t, u)
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=dev))
    sh = s.permute(0, 1, 3, 2)  # (b, nc, h, Q)
    seg = sh[..., :, None] - sh[..., None, :]
    L = torch.where(tri, torch.exp(torch.clamp(seg, max=0.0)), 0.0)
    dtu = dtf.permute(0, 1, 3, 2)[..., None, :]
    CB = torch.einsum("bcthn,bcuhn->bchtu", Cf, Bf)
    dM = torch.einsum("bcthp,bcuhp->bchtu", dyf, xf)
    M = CB * L * dtu
    dCB = dM * L * dtu
    Z = dM * M
    BL = torch.einsum("bcuhn,bchpn->bcuhp", Bf, Lam)
    dx = torch.einsum("bchtu,bcthp->bcuhp", M, dyf) + w[..., None] * BL
    dyS = torch.einsum("bcthp,bchpn->bcthn", dyf, S0)
    xL = torch.einsum("bcuhp,bchpn->bcuhn", xf, Lam)
    # dB and dC: the heads of each head group folded in order, then the group's
    # summed dCB term, then the groups folded in order (the kernels' schedule)
    hg, ng = bwd_head_groups(b, t, rep)
    hpad = hg * ng - rep

    def by_group(v, dim):  # the head axis ``dim`` (g x rep) -> (g, ng, hg), zeros past rep
        v = v.unflatten(dim, (g, rep))
        if hpad:
            v = torch.cat([v, v.new_zeros(v.shape[:dim + 1] + (hpad,) + v.shape[dim + 2:])],
                          dim + 1)
        return v.unflatten(dim + 1, (ng, hg))

    dCBg = _fold(by_group(dCB, 2), 4)  # (b, nc, g, ng, Q, Q)
    Bg, Cg = B.to(acc).reshape(b, nc, q, g, n), C.to(acc).reshape(b, nc, q, g, n)
    dCg = (_fold(by_group(e[..., None] * dyS, 3), 5)
           + torch.einsum("bcgktu,bcugn->bctgkn", dCBg, Bg))
    dBg = (_fold(by_group(w[..., None] * xL, 3), 5)
           + torch.einsum("bcgktu,bctgn->bcugkn", dCBg, Cg))
    xLB = (xL * Bf).sum(-1)  # (b, nc, Q, h)
    ds = (e * (Cf * dyS).sum(-1) + Z.sum(-1).permute(0, 1, 3, 2)
          - Z.sum(-2).permute(0, 1, 3, 2) - w * xLB)
    ds[:, :, -1] += (w * xLB).sum(2) + decay * (Lam * S0).sum((-2, -1))
    r = torch.flip(torch.cumsum(torch.flip(ds, [2]), dim=2), [2])
    ddt = ((dM * CB * L).sum(-2).permute(0, 1, 3, 2)
           + torch.exp(last[:, :, None] - s) * xLB + Af * r)
    dA = _fold((dtf * r).sum(2).reshape(b * nc, h), 0)
    dx = dx.reshape(b, nc * q, h, p)[:, :t].to(x.dtype)
    ddt = ddt.reshape(b, nc * q, h)[:, :t].contiguous()
    fold = lambda v: _fold(v.reshape(b, nc * q, g, ng, n)[:, :t], 3)  # noqa: E731
    return dx, ddt, dA, fold(dBg).to(B.dtype), fold(dCg).to(C.dtype), d_init


ssd_bwd_torch.calls = 0


# ---------------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------------
_p, _i = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Binding("ssd_scan", {
    "repro_ssd_scan": [_i, _p, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _i, _i, _p],
    "repro_ssd_blocks_per_sm": [_i, _i, ctypes.POINTER(_i)],  # no stream
}, geometry=GEOMETRY)


def grid_blocks(b: int, h: int, p: int) -> int:
    """Blocks of the scan kernel for b sequences of h heads of head dim p: one
    per (sequence, head, GEOMETRY["p_slice"] columns of p)."""
    return b * h * -(-p // GEOMETRY["p_slice"])


@functools.lru_cache(maxsize=64)
def blocks_per_sm(dtype: torch.dtype, n: int, device: torch.device) -> int:
    """Blocks of the scan kernel for ``dtype`` and state size n that fit on
    one SM of ``device`` at once, registers and shared memory included (the
    library's occupancy query), asked once each."""
    out = _i(0)
    with torch.cuda.device(device):
        rc = _LIB.lib().repro_ssd_blocks_per_sm(_DTYPE_CODE[dtype], n, ctypes.byref(out))
    if rc != 0:
        msg = _LIB.lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan occupancy query failed: CUDA error {rc} ({msg})")
    return out.value


def _check(name: str, t: torch.Tensor, shape, dtype, device) -> None:
    no_dtensor(name, t)
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def ssd_scan(x, dt, A, B, C, *, chunk: int = 64, initial_state: Optional[torch.Tensor] = None,
             return_final_state: bool = False):
    """SSD chunked scan, ngroups 1 (kernels: cb_kernel, a block per
    (sequence, 64-step chunk), then ssd_kernel, a block per (sequence, head,
    GEOMETRY["p_slice"] columns of p)). On CUDA: x, B, C one of
    float32/bfloat16 (B, C in x's dtype), dt, A and the initial state float32,
    all contiguous, n <= MAX_STATE; any t (``chunk`` sets only the plain
    version's chunking, see the module docstring)."""
    if x.device.type == "cpu":
        return ssd_torch(x, dt, A, B, C, chunk=chunk, initial_state=initial_state,
                         return_final_state=return_final_state)
    no_grad_through("ssd_scan", x, dt, A, B, C, initial_state)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be (b, t, h, p) float32 or bfloat16, got {tuple(x.shape)} "
                        f"{x.dtype}")
    b, t, h, p = x.shape
    if B.dim() != 4 or B.shape[2] != 1:
        raise ValueError(f"the kernel takes ngroups 1: B (b, t, 1, n), got {tuple(B.shape)}")
    n = B.shape[3]
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"n_state {n} outside 1..{MAX_STATE}")
    dev = x.device
    _check("x", x, (b, t, h, p), x.dtype, dev)
    _check("dt", dt, (b, t, h), torch.float32, dev)
    _check("A", A, (h,), torch.float32, dev)
    _check("B", B, (b, t, 1, n), x.dtype, dev)
    _check("C", C, (b, t, 1, n), x.dtype, dev)
    if initial_state is not None:
        _check("initial_state", initial_state, (b, h, p, n), torch.float32, dev)
    y = torch.empty_like(x)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=dev)
    q = GEOMETRY["chunk"]
    cb = torch.empty((b, -(-t // q), q, q), dtype=torch.float32, device=dev)  # C . B a chunk
    _LIB.launch(
        "repro_ssd_scan", "ssd_scan",
        _DTYPE_CODE[x.dtype], x.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
        C.data_ptr(), initial_state.data_ptr() if initial_state is not None else None,
        y.data_ptr(), state.data_ptr(), cb.data_ptr(), b, t, h, p, n, device=dev,
    )
    ssd_scan.launches += 1
    if return_final_state:
        return y, state
    return y


ssd_scan.launches = 0


# ---------------------------------------------------------------------------------
# the backward: CUDA kernel wrapper and the autograd Function
# ---------------------------------------------------------------------------------
# csrc/ssd_scan_bwd.cu's kGeometry, in its order: the chunk, the state columns a
# tile (pass blocks, the chunk kernels' S / Lam stages), the largest head dim,
# the pass kernel's threads and ring stages, the chunk kernels' threads (np <=
# 128; twice that at np 256) and the blocks the head groups aim for
BWD_GEOMETRY = {"chunk": 64, "tile": 64, "max_head_dim": 64, "pass_threads": 128,
                "pass_stages": 2, "chunk_threads": 256, "fill_blocks": 528}
_BWD_LIB = _build.Binding("ssd_scan_bwd", {
    "repro_ssd_scan_bwd": [_i] + [_p] * 21 + [_i] * 6 + [_p],
    "repro_ssd_bwd_blocks_per_sm": [_i, _i, ctypes.POINTER(_i)],  # no stream
}, geometry=BWD_GEOMETRY)


def bwd_head_groups(b: int, t: int, h: int):
    """(heads a group, groups) of ssd_scan_bwd's chunk kernels for b
    sequences of t steps and h heads sharing B and C: ``want`` = the groups
    that make b x ceil(t / 64) x groups reach BWD_GEOMETRY["fill_blocks"]
    blocks (1 to h), groups of ceil(h / want) heads, a short last group
    where that does not divide h (rounding the size up may leave fewer
    groups than ``want``). csrc/ssd_scan_bwd.cu::head_group_size plans the
    same and refuses another."""
    nc = -(-t // BWD_GEOMETRY["chunk"])
    groups = min(h, max(1, -(-BWD_GEOMETRY["fill_blocks"] // (b * nc))))
    hg = -(-h // groups)
    return hg, -(-h // hg)


def bwd_workspace_shapes(b: int, t: int, h: int, n: int):
    """The f32 workspaces ssd_scan_bwd allocates a call, by name (None: not
    allocated): the S_c and Lam_c planes (b, nc, h, 64, np) (np = n rounded up
    to 64; bf16 keeps a hi and a lo plane in the same bytes), the groups'
    summed dCB (b, nc, groups, 64, 64), the ds pieces (b, nc, h, 3, 64), the
    group partials of dB and dC (b, t, groups, n) with more than one group,
    and dA's partials (b, nc, h)."""
    q, nt = BWD_GEOMETRY["chunk"], BWD_GEOMETRY["tile"]
    nc, np_ = -(-t // q), -(-n // nt) * nt
    _, groups = bwd_head_groups(b, t, h)
    part = (b, t, groups, n) if groups > 1 else None
    return {"states": (b, nc, h, q, np_), "lams": (b, nc, h, q, np_),
            "dcb": (b, nc, groups, q, q), "aux": (b, nc, h, 3, q), "dbp": part, "dcp": part,
            "dap": (b, nc, h)}


def bwd_workspace_bytes(b: int, t: int, h: int, n: int) -> int:
    """Bytes of the workspaces ssd_scan_bwd allocates a call at this shape."""
    return sum(4 * math.prod(s) for s in bwd_workspace_shapes(b, t, h, n).values()
               if s is not None)


@functools.lru_cache(maxsize=64)
def bwd_blocks_per_sm(dtype: torch.dtype, n: int, device: torch.device):
    """Blocks of the backward's chunk kernels (lam_kernel, s_kernel) and of
    its pass_kernel for ``dtype`` and state size n that fit on one SM of
    ``device`` at once, and the chunk kernels' shared memory bytes (the
    library's occupancy query), asked once each."""
    out = (_i * 5)()
    with torch.cuda.device(device):
        rc = _BWD_LIB.lib().repro_ssd_bwd_blocks_per_sm(_DTYPE_CODE[dtype], n, out)
    if rc != 0:
        msg = _BWD_LIB.lib().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"ssd_scan_bwd occupancy query failed: CUDA error {rc} ({msg})")
    return {"lam_kernel": out[0], "s_kernel": out[1], "pass_kernel": out[2],
            "lam_smem_bytes": out[3], "s_smem_bytes": out[4]}


def ssd_scan_bwd(x, dt, A, B, C, dy, *, initial_state: Optional[torch.Tensor] = None,
                 d_final_state: Optional[torch.Tensor] = None):
    """The gradient of ``ssd_scan`` (kernels: csrc/ssd_scan_bwd.cu, the state
    and adjoint passes in one launch, then two chunk kernels a (head group,
    chunk, sequence) that fold dB and dC over the group's heads on chip (bf16
    on mma.sync, f32 values as hi + lo planes; f32 on the CUDA cores), then the
    folds of the group partials and of dA over (sequence, chunk) in a fixed
    order). Inputs as ``ssd_scan`` takes them, dy (b, t, h, p) in x's dtype
    (None: zeros), ``d_final_state`` (b, h, p, n) f32 or None; head dim <= 64.
    -> (dx, ddt, dA, dB, dC, d_initial_state), as ``ssd_bwd_torch`` returns
    them. On CPU tensors: ``ssd_bwd_torch``; on CUDA tensors it launches the
    kernels or raises. Its calls are counted in ``.launches``."""
    if x.device.type == "cpu":
        return ssd_bwd_torch(x, dt, A, B, C, dy, initial_state=initial_state,
                             d_final_state=d_final_state)
    if x.device.type != "cuda":
        raise ValueError(f"x must be a CUDA tensor, got {x.device}")
    if x.dim() != 4 or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"x must be (b, t, h, p) float32 or bfloat16, got {tuple(x.shape)} "
                        f"{x.dtype}")
    b, t, h, p = x.shape
    if B.dim() != 4 or B.shape[2] != 1:
        raise ValueError(f"the kernel takes ngroups 1: B (b, t, 1, n), got {tuple(B.shape)}")
    n = B.shape[3]
    if not 0 < n <= MAX_STATE:
        raise ValueError(f"n_state {n} outside 1..{MAX_STATE}")
    if p > BWD_GEOMETRY["max_head_dim"]:
        raise ValueError(f"head dim {p} past the backward's {BWD_GEOMETRY['max_head_dim']}")
    dev = x.device
    if dy is None:
        dy = torch.zeros_like(x)
    for name, ten, shape, dtype in (
            ("x", x, (b, t, h, p), x.dtype), ("dt", dt, (b, t, h), torch.float32),
            ("A", A, (h,), torch.float32), ("B", B, (b, t, 1, n), x.dtype),
            ("C", C, (b, t, 1, n), x.dtype), ("dy", dy, (b, t, h, p), x.dtype)):
        _check(name, ten, shape, dtype, dev)
    for name, ten in (("initial_state", initial_state), ("d_final_state", d_final_state)):
        if ten is not None:
            _check(name, ten, (b, h, p, n), torch.float32, dev)
    f32 = dict(dtype=torch.float32, device=dev)
    dx, dB, dC = torch.empty_like(x), torch.empty_like(B), torch.empty_like(C)
    ddt, dA = torch.empty((b, t, h), **f32), torch.empty((h,), **f32)
    d_init = torch.empty((b, h, p, n), **f32) if initial_state is not None else None
    ws = {k: None if s is None else torch.empty(s, **f32)
          for k, s in bwd_workspace_shapes(b, t, h, n).items()}
    ptr = lambda ten: ten.data_ptr() if ten is not None else None  # noqa: E731
    _BWD_LIB.launch(
        "repro_ssd_scan_bwd", "ssd_scan_bwd",
        _DTYPE_CODE[x.dtype], *map(ptr, (x, dt, A, B, C, dy, initial_state, d_final_state, dx,
                                         ddt, dA, dB, dC, d_init, ws["states"], ws["lams"],
                                         ws["dcb"], ws["aux"], ws["dbp"], ws["dcp"], ws["dap"])),
        b, t, h, p, n, bwd_head_groups(b, t, h)[0], device=dev,
    )
    ssd_scan_bwd.launches += 1
    return dx, ddt, dA, dB, dC, d_init


ssd_scan_bwd.launches = 0


class SSDScanFn(torch.autograd.Function):
    """The SSD scan with a gradient: forward on ``ssd_scan``'s kernel,
    backward on ``ssd_scan_bwd``'s (on CPU tensors their plain versions,
    ``ssd_torch`` and ``ssd_bwd_torch``, at chunk 64). Returns (y, the final
    state); either may carry a gradient. Saves only the inputs: the backward
    recomputes the chunk-start states by its own state pass."""

    @staticmethod
    def forward(ctx, x, dt, A, B, C, initial_state):
        y, state = ssd_scan(x, dt, A, B, C, initial_state=initial_state,
                            return_final_state=True)
        ctx.save_for_backward(x, dt, A, B, C, initial_state)
        ctx.set_materialize_grads(False)
        return y, state

    @staticmethod
    def backward(ctx, dy, d_state):
        if dy is None and d_state is None:
            return (None,) * 6
        x, dt, A, B, C, initial_state = ctx.saved_tensors
        return ssd_scan_bwd(x, dt, A, B, C, None if dy is None else dy.contiguous(),
                            initial_state=initial_state,
                            d_final_state=None if d_state is None else d_state.contiguous())


KERNEL_WRAPPERS = {"ssd_scan": ssd_scan, "ssd_scan_bwd": ssd_scan_bwd}
