"""Mamba-2 SSD (state-space duality) chunked scan: the plain PyTorch version
and the wrapper that launches the hand-written CUDA kernel.

Port of ``repro.kernels.ssd_scan`` and of the reference's chunked jnp twin:

  ssd_torch  <- ops.ssd_jnp (the chunked twin, any ngroups)
  ssd_scan   <- ssd_scan (Pallas, ngroups 1) — launches
                csrc/ssd_scan.cu::cb_kernel (C . B once per sequence and
                chunk, into a workspace) then ::ssd_kernel (the scan)

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

On CPU tensors the wrapper returns the plain version; on CUDA tensors it
launches the kernels or raises. Its calls are counted in ``.launches``: one a
call, the two kernels of the C entry together.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch
import torch.nn.functional as F

from . import _build
from .common import no_grad_through

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_STATE = 256  # n_state the kernel's shared-memory tiles hold at most
# csrc/ssd_scan.cu's kGeometry, in its order; the library is checked against
# it when it loads: the kernel's chunk (the C . B workspace's tile), the
# columns of P a block takes and its threads.
GEOMETRY = {"chunk": 64, "p_slice": 32, "threads": 256}


# ---------------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------------
def ssd_torch(x, dt, A, B, C, *, chunk: int = 64, initial_state=None,
              return_final_state: bool = False):
    """Chunked SSD, the reference's ``ssd_jnp``: f32 throughout, a loop over
    chunks carrying the (b, h, p, n) state."""
    b, t, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    rep = h // g
    pad = -t % chunk
    if pad:  # dt = 0, x = 0 steps leave y and the state unchanged
        x, dt = F.pad(x, (0, 0, 0, 0, 0, pad)), F.pad(dt, (0, 0, 0, pad))
        B, C = F.pad(B, (0, 0, 0, 0, 0, pad)), F.pad(C, (0, 0, 0, 0, 0, pad))
    tp = t + pad
    nc = tp // chunk
    xf = x.float().reshape(b, nc, chunk, h, p)
    dtf = dt.float().reshape(b, nc, chunk, h)
    Bf = B.float().repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    Cf = C.float().repeat_interleave(rep, dim=2).reshape(b, nc, chunk, h, n)
    Af = A.float()
    tri = torch.tril(torch.ones((chunk, chunk), dtype=torch.float32, device=x.device))
    S = (torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
         if initial_state is None else initial_state.float())
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

KERNEL_WRAPPERS = {"ssd_scan": ssd_scan}
