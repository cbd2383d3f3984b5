"""repro_torch's plain SSD scan (ssd_torch, what the CUDA kernel is held
against on the card) at the kernel's own 64-step chunk and at mamba2-780m's
full width (48 heads of 64, N 128), against the reference: its Pallas
ssd_scan in interpret mode and its sequential oracle (ref.ssd_scan).

The same numpy inputs, made from a seed, go through both packages, with and
without an initial state. A ragged T (77, no multiple of 64) is held against
the oracle only: the Pallas kernel asserts t % chunk == 0, and ssd_torch pads
the tail with dt = x = 0 as the kernel masks it. Tolerance 2e-3, the
reference's (tests/test_torch_ssd.py's TOL).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro_torch.kernels import ssd_scan as tss

TOL = dict(rtol=2e-3, atol=2e-3)
WIDTH = dict(h=48, p=64, n=128)  # mamba2-780m (arXiv:2405.21060)
CHUNK = 64  # csrc/ssd_scan.cu's kQ


def _inputs(b, t, seed):
    rng = np.random.default_rng(seed)
    h, p, n = WIDTH["h"], WIDTH["p"], WIDTH["n"]
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(b, t, h, p) * 0.5
    dt = np.log1p(np.exp(f(b, t, h))).astype(np.float32)  # softplus
    A = -np.exp(f(h) * 0.3).astype(np.float32)
    B, C = f(b, t, 1, n) * 0.3, f(b, t, 1, n) * 0.3
    s0 = f(b, h, p, n) * 0.5
    return (x, dt, A, B, C), s0


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


def _close(got, want):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("initial", [False, True], ids=["zero_state", "initial_state"])
def test_plain_at_the_kernel_chunk_and_full_width_matches_pallas_and_oracle(initial):
    arrays, s0 = _inputs(1, 128, seed=31)
    init = s0 if initial else None
    got, gs = tss.ssd_torch(*_t(*arrays), chunk=CHUNK,
                            initial_state=None if init is None else _t(init)[0],
                            return_final_state=True)
    jinit = None if init is None else jnp.asarray(init)
    want, ws = jssd(*_j(*arrays), chunk=CHUNK, initial_state=jinit, return_final_state=True)
    _close(got, want)
    _close(gs, ws)
    oy, os_ = ref.ssd_scan(*_j(*arrays), initial_state=jinit, return_final_state=True)
    _close(got, oy)
    _close(gs, os_)


@pytest.mark.parametrize("initial", [False, True], ids=["zero_state", "initial_state"])
def test_plain_ragged_t_at_full_width_matches_oracle(initial):
    arrays, s0 = _inputs(1, 77, seed=32)
    init = s0 if initial else None
    got, gs = tss.ssd_torch(*_t(*arrays), chunk=CHUNK,
                            initial_state=None if init is None else _t(init)[0],
                            return_final_state=True)
    oy, os_ = ref.ssd_scan(*_j(*arrays), initial_state=None if init is None else jnp.asarray(init),
                           return_final_state=True)
    _close(got, oy)
    _close(gs, os_)
