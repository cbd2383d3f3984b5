"""RG-LRU gated linear recurrence h_t = a_t * h_{t-1} + b_t: the plain
PyTorch version and the wrapper that launches the hand-written CUDA kernel.

Port of ``repro.kernels.rglru_scan`` and of the associative scan the
reference's ``models/rglru.py`` runs in its place:

  rglru_torch  <- jax.lax.associative_scan with models/rglru.py's ``combine``
                  (the same recursive odd/even scan, in f32)
  rglru_scan   <- rglru_scan (Pallas) — launches csrc/rglru_scan.cu::rglru_kernel

a, b (B, T, W): the precomputed decay and input terms (the gates stay outside,
as in the reference); an optional f32 initial state (B, W). Returns y (B, T,
W) in a's dtype [and the f32 final state (B, W)]. Any T: the Pallas kernel's
``T % chunk == 0`` has no counterpart, so no padding is needed.

The kernel runs the recurrence as a sequential chain, one lane a column, in
t order (so two chained halves give the bits of one run), and keeps a ring of
stages of a and b in shared memory full from other warps, so the chain never
waits on device memory (the source's header). A block owns GEOMETRY["columns"]
columns of one sequence; the library launches one block for each.

On CPU tensors the wrapper returns the plain version; on CUDA tensors it
launches the kernel or raises. Its launches are counted in ``.launches``.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import _build
from .common import no_grad_through

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
    af, bf = a.float(), b.float()
    if initial_state is not None:
        bf = bf.clone()
        bf[:, 0] += af[:, 0] * initial_state.float()
    _, h = _associative_scan(af, bf)
    y = h.to(a.dtype)
    if return_final_state:
        return y, h[:, -1]
    return y


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

KERNEL_WRAPPERS = {"rglru_scan": rglru_scan}
