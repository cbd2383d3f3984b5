"""RG-LRU gated linear recurrence h_t = a_t * h_{t-1} + b_t: the plain
PyTorch version and the wrapper that launches the hand-written CUDA kernel.

Port of ``repro.kernels.rglru_scan`` and of the associative scan the
reference's ``models/rglru.py`` runs in its place:

  rglru_torch      <- jax.lax.associative_scan with models/rglru.py's
                      ``combine`` (the same recursive odd/even scan, in f32)
  rglru_scan       <- rglru_scan (Pallas) — launches
                      csrc/rglru_scan.cu::rglru_kernel
  rglru_bwd_torch  <- the scan's gradient, which the reference takes by
                      autodiff: its plain twin, the reverse recurrence
  rglru_scan_bwd   <- the same gradient — launches
                      csrc/rglru_scan_bwd.cu::rglru_bwd_kernel
  RGLRUScanFn      the autograd Function the card trains through: rglru_scan
                      forward, rglru_scan_bwd backward

a, b (B, T, W): the precomputed decay and input terms (the gates stay outside,
as in the reference); an optional f32 initial state (B, W). Returns y (B, T,
W) in a's dtype [and the f32 final state (B, W)]. Any T: the Pallas kernel's
``T % chunk == 0`` has no counterpart, so no padding is needed.

The kernel runs the recurrence as a sequential chain, one lane a column, in
t order (so two chained halves give the bits of one run), and keeps a ring of
stages of a and b in shared memory full from other warps, so the chain never
waits on device memory (the source's header). A block owns GEOMETRY["columns"]
columns of one sequence; the library launches one block for each.

On CPU tensors the wrappers return the plain versions; on CUDA tensors they
launch the kernels or raise. Their launches are counted in ``.launches``.
``rglru_scan`` has no backward of its own (it raises under grad on the
card); a gradient goes through RGLRUScanFn.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .common import no_dtensor, no_grad_through

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
# csrc/rglru_scan.cu's kGeometry, in its order; the library is checked against
# it when it loads: the columns of a work item (one chain lane each), the time
# steps of a stage, the stages of the ring and the threads of a block.
GEOMETRY = {"columns": 32, "steps": 32, "stages": 4, "threads": 96}


# ---------------------------------------------------------------------------------
# plain PyTorch version
# ---------------------------------------------------------------------------------
def _combine(lhs, rhs):
    """The reference's combine: (a_l, b_l) then (a_r, b_r) -> (a_l a_r, a_r b_l + b_r)."""
    al, bl = lhs
    ar, br = rhs
    return al * ar, ar * bl + br


def _interleave(even: torch.Tensor, odd: torch.Tensor) -> torch.Tensor:
    """even[0], odd[0], even[1], ... along dim 1 (even has as many rows as odd
    or one more)."""
    out = even.new_empty((even.shape[0], even.shape[1] + odd.shape[1]) + even.shape[2:])
    out[:, 0::2] = even
    out[:, 1::2] = odd
    return out


def _associative_scan(a: torch.Tensor, b: torch.Tensor):
    """Inclusive scan of (a, b) along dim 1 under ``_combine``: JAX's
    associative_scan (combine adjacent pairs, scan the half, fix up the even
    positions), log-depth in T."""
    n = a.shape[1]
    if n < 2:
        return a, b
    odd = _associative_scan(*_combine((a[:, 0:-1:2], b[:, 0:-1:2]), (a[:, 1::2], b[:, 1::2])))
    if n % 2 == 0:
        even = _combine((odd[0][:, :-1], odd[1][:, :-1]), (a[:, 2::2], b[:, 2::2]))
    else:
        even = _combine(odd, (a[:, 2::2], b[:, 2::2]))
    return tuple(_interleave(torch.cat([x[:, :1], e], dim=1), o)
                 for x, e, o in zip((a, b), even, odd))


def rglru_torch(a, b, initial_state: Optional[torch.Tensor] = None,
                return_final_state: bool = False):
    """The recurrence as the reference's model computes it: f32, the initial
    state folded into the first step (b_0 += a_0 * h0), then the associative
    scan; y in a's dtype, the final state in f32."""
    rglru_torch.calls += 1
    acc = torch.float64 if a.dtype == torch.float64 else torch.float32
    af, bf = a.to(acc), b.to(acc)
    if initial_state is not None:
        bf = bf.clone()
        bf[:, 0] += af[:, 0] * initial_state.to(acc)
    _, h = _associative_scan(af, bf)
    y = h.to(a.dtype)
    if return_final_state:
        return y, h[:, -1]
    return y


rglru_torch.calls = 0


def rglru_bwd_torch(a, h, dy, *, initial_state=None, d_final_state=None):
    """The gradient of the recurrence, the plain twin of rglru_scan_bwd's
    kernel: from the states h (B, T, W) of the forward in f32 (f64 for f64
    inputs), the reverse recurrence

        Lam_t = dy_t + a_{t+1} Lam_{t+1},  Lam_{T-1} = dy_{T-1} + d_final_state
        db_t = Lam_t,  da_t = Lam_t h_{t-1},  d_initial_state = a_0 Lam_0

    with h_{-1} the initial state (0 without one: the forward's fold b_0 +=
    a_0 h0 gives a_0 the same term). dy (B, T, W) or None. -> (da, db in a's
    dtype, d_initial_state f32 or None without an initial state). A loop
    over t, one step at a time in the kernel's order. Its calls are counted
    in ``.calls``."""
    rglru_bwd_torch.calls += 1
    acc = h.dtype
    bsz, t, w = a.shape
    af = a.to(acc)
    dyf = torch.zeros_like(h) if dy is None else dy.to(acc)
    h0 = (torch.zeros((bsz, w), dtype=acc, device=a.device) if initial_state is None
          else initial_state.to(acc))
    hprev = torch.cat([h0[:, None], h[:, :-1]], dim=1)
    carry = (torch.zeros((bsz, w), dtype=acc, device=a.device) if d_final_state is None
             else d_final_state.to(acc))
    lam = torch.empty_like(dyf)
    for i in reversed(range(t)):
        lam[:, i] = dyf[:, i] + carry
        carry = af[:, i] * lam[:, i]
    da = (lam * hprev).to(a.dtype)
    return da, lam.to(a.dtype), (carry if initial_state is not None else None)


rglru_bwd_torch.calls = 0


# ---------------------------------------------------------------------------------
# CUDA kernel wrapper
# ---------------------------------------------------------------------------------
_p, _i = ctypes.c_void_p, ctypes.c_int
_LIB = _build.Binding("rglru_scan", {
    "repro_rglru_scan": [_i, _p, _p, _p, _p, _p, _i, _i, _i, _p],
}, geometry=GEOMETRY)


def rglru_scan(a, b, *, initial_state: Optional[torch.Tensor] = None,
               return_final_state: bool = False):
    """The recurrence (kernel: rglru_kernel, a chain lane per column fed by a
    ring of staged steps). On CUDA: a
    and b contiguous, one of float32/bfloat16 (b in a's dtype), the initial
    state float32 (B, W) and contiguous; any T."""
    if a.device.type == "cpu":
        return rglru_torch(a, b, initial_state, return_final_state)
    no_grad_through("rglru_scan", a, b, initial_state)
    if a.device.type != "cuda":
        raise ValueError(f"a must be a CUDA tensor, got {a.device}")
    if a.dim() != 3 or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"a must be (B, T, W) float32 or bfloat16, got {tuple(a.shape)} "
                        f"{a.dtype}")
    bsz, t, w = a.shape
    if b.device != a.device or b.dtype != a.dtype or b.shape != a.shape:
        raise TypeError(f"b must match a ({tuple(a.shape)} {a.dtype} on {a.device}), got "
                        f"{tuple(b.shape)} {b.dtype} on {b.device}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("a and b must be contiguous")
    if initial_state is not None:
        if (initial_state.device != a.device or initial_state.dtype != torch.float32
                or tuple(initial_state.shape) != (bsz, w)):
            raise TypeError(f"initial_state must be float32 {(bsz, w)} on {a.device}, got "
                            f"{initial_state.dtype} {tuple(initial_state.shape)} on "
                            f"{initial_state.device}")
        if not initial_state.is_contiguous():
            raise ValueError("initial_state must be contiguous")
    y = torch.empty_like(a)
    h_final = torch.empty((bsz, w), dtype=torch.float32, device=a.device)
    _LIB.launch(
        "repro_rglru_scan", "rglru_scan",
        _DTYPE_CODE[a.dtype], a.data_ptr(), b.data_ptr(),
        initial_state.data_ptr() if initial_state is not None else None,
        y.data_ptr(), h_final.data_ptr(), bsz, t, w, device=a.device,
    )
    rglru_scan.launches += 1
    if return_final_state:
        return y, h_final
    return y


rglru_scan.launches = 0


# ---------------------------------------------------------------------------------
# the backward: CUDA kernel wrapper and the autograd Function
# ---------------------------------------------------------------------------------
# csrc/rglru_scan_bwd.cu's kGeometry, in its order (the forward's shape: the
# columns of a work item, the steps of a stage, the stages of the ring, the
# threads of a block)
BWD_GEOMETRY = {"columns": 32, "steps": 32, "stages": 4, "threads": 96}
_BWD_LIB = _build.Binding("rglru_scan_bwd", {
    "repro_rglru_scan_bwd": [_i, _p, _p, _p, _p, _p, _p, _p, _p, _i, _i, _i, _p],
}, geometry=BWD_GEOMETRY)


def rglru_scan_bwd(a, h, dy, *, initial_state: Optional[torch.Tensor] = None,
                   d_final_state: Optional[torch.Tensor] = None):
    """The gradient of the recurrence (kernel: rglru_bwd_kernel, a chain lane
    per column walking t downward, fed by a ring of staged (a_t, dy_t,
    h_{t-1}) steps). a and dy (B, T, W) contiguous in one of float32/bfloat16
    (dy None: zeros), h the forward's states (B, T, W) f32, the initial state
    and ``d_final_state`` (B, W) f32 or None. -> (da, db, d_initial_state), as
    ``rglru_bwd_torch`` returns them (the f32 kernel gives its bits). On CPU
    tensors: ``rglru_bwd_torch``; on CUDA tensors it launches the kernel or
    raises. Its launches are counted in ``.launches``."""
    no_dtensor("rglru_scan_bwd", a, h, dy, initial_state, d_final_state)
    if a.device.type == "cpu":
        return rglru_bwd_torch(a, h, dy, initial_state=initial_state,
                               d_final_state=d_final_state)
    if a.device.type != "cuda":
        raise ValueError(f"a must be a CUDA tensor, got {a.device}")
    if a.dim() != 3 or a.dtype not in _DTYPE_CODE:
        raise TypeError(f"a must be (B, T, W) float32 or bfloat16, got {tuple(a.shape)} "
                        f"{a.dtype}")
    bsz, t, w = a.shape
    if dy is None:
        dy = torch.zeros_like(a)
    for name, ten, shape, dtype in (("dy", dy, a.shape, a.dtype), ("h", h, a.shape, torch.float32),
                                    ("initial_state", initial_state, (bsz, w), torch.float32),
                                    ("d_final_state", d_final_state, (bsz, w), torch.float32)):
        if ten is None:
            continue
        if ten.device != a.device or ten.dtype != dtype or tuple(ten.shape) != tuple(shape):
            raise TypeError(f"{name} must be {dtype} {tuple(shape)} on {a.device}, got "
                            f"{ten.dtype} {tuple(ten.shape)} on {ten.device}")
        if not ten.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not a.is_contiguous():
        raise ValueError("a must be contiguous")
    da, db = torch.empty_like(a), torch.empty_like(a)
    d_init = (torch.empty((bsz, w), dtype=torch.float32, device=a.device)
              if initial_state is not None else None)
    ptr = lambda ten: ten.data_ptr() if ten is not None else None  # noqa: E731
    _BWD_LIB.launch(
        "repro_rglru_scan_bwd", "rglru_scan_bwd",
        _DTYPE_CODE[a.dtype], *map(ptr, (a, dy, h, initial_state, d_final_state, da, db, d_init)),
        bsz, t, w, device=a.device,
    )
    rglru_scan_bwd.launches += 1
    return da, db, d_init


rglru_scan_bwd.launches = 0


class RGLRUScanFn(torch.autograd.Function):
    """The recurrence with a gradient: forward on ``rglru_scan``'s kernel,
    backward on ``rglru_scan_bwd``'s (on CPU tensors their plain versions).
    Takes f32 a and b, as both models feed it (f64 too, on the CPU's plain
    versions), and returns (y, the f32 final state); either may carry a
    gradient. Saves a and the states, which are y itself."""

    @staticmethod
    def forward(ctx, a, b, initial_state):
        if a.dtype not in (torch.float32, torch.float64) or b.dtype != a.dtype:
            raise TypeError(f"RGLRUScanFn takes f32 a and b, got {a.dtype} and {b.dtype}")
        h, h_final = rglru_scan(a, b, initial_state=initial_state, return_final_state=True)
        ctx.save_for_backward(a, h, initial_state)
        ctx.set_materialize_grads(False)
        return h, h_final

    @staticmethod
    def backward(ctx, dy, d_final):
        if dy is None and d_final is None:
            return None, None, None
        a, h, initial_state = ctx.saved_tensors
        return rglru_scan_bwd(a, h, None if dy is None else dy.contiguous(),
                              initial_state=initial_state,
                              d_final_state=None if d_final is None else d_final.contiguous())


KERNEL_WRAPPERS = {"rglru_scan": rglru_scan, "rglru_scan_bwd": rglru_scan_bwd}
