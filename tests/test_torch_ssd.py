"""repro_torch's SSD scan (ops.ssd's plain version beside the ssd_scan CUDA
kernel, and ops.ssd_decode_step) against the reference: its Pallas ssd_scan
in interpret mode, its chunked jnp twin and its sequential oracle
(ref.ssd_scan).

The same numpy inputs, made from a seed, go through both packages; the cases
are the reference's (tests/test_kernels_lm.py): chunk 16/32/64 at both sweep
shapes, state chaining, ngroups 2 (the plain path), plus the model's ragged
``chunk = t`` setting and one decode step. Tolerance 2e-3, the reference's.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.ssd_scan import ssd_scan as jssd
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.kernels import ssd_scan as tss

TOL = dict(rtol=2e-3, atol=2e-3)


def _inputs(b, t, h, p, n, g=1, seed=7):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)
    x = f(b, t, h, p) * 0.5
    dt = np.log1p(np.exp(f(b, t, h))).astype(np.float32)  # softplus
    A = -np.exp(f(h) * 0.3).astype(np.float32)
    B, C = f(b, t, g, n) * 0.3, f(b, t, g, n) * 0.3
    return x, dt, A, B, C


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


@pytest.mark.parametrize("chunk", [16, 32, 64])
@pytest.mark.parametrize("shape", [(2, 128, 4, 16, 32), (1, 64, 8, 8, 16)])
def test_ssd_matches_pallas_kernel_and_oracle(chunk, shape):
    arrays = _inputs(*shape)
    want, ws = jssd(*_j(*arrays), chunk=chunk, return_final_state=True)
    got, gs = ops.ssd(*_t(*arrays), chunk=chunk, return_final_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    oy, os_ = ref.ssd_scan(*_j(*arrays), return_final_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(oy), **TOL)
    np.testing.assert_allclose(gs.numpy(), np.asarray(os_), **TOL)


def test_ssd_groups_match_jnp_twin():
    """ngroups 2 (heads share B/C in pairs): the plain path, as the reference
    sends g > 1 to its jnp twin."""
    arrays = _inputs(2, 64, 4, 8, 16, g=2, seed=8)
    want = jops.ssd_jnp(*_j(*arrays), chunk=16)
    np.testing.assert_allclose(ops.ssd(*_t(*arrays), chunk=16).numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(ops.ssd(*_t(*arrays), chunk=16).numpy(),
                               np.asarray(ref.ssd_scan(*_j(*arrays))), **TOL)


def test_ssd_state_chaining_matches_full_run():
    """A run split in two with the state carried equals one long run (the
    prefill invariant), against the reference's oracle."""
    x, dt, A, B, C = _inputs(1, 64, 2, 8, 16, seed=9)
    y_full = ref.ssd_scan(*_j(x, dt, A, B, C))
    half = 32
    first = [a[:, :half] for a in (x, dt)] + [A] + [a[:, :half] for a in (B, C)]
    second = [a[:, half:] for a in (x, dt)] + [A] + [a[:, half:] for a in (B, C)]
    y1, s1 = ops.ssd(*_t(*first), chunk=16, return_final_state=True)
    y2 = ops.ssd(*_t(*second), chunk=16, initial_state=s1)
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), np.asarray(y_full), **TOL)
    # and the reference's kernel chained the same way
    jy1, js1 = jssd(*_j(*first), chunk=16, return_final_state=True)
    jy2 = jssd(*_j(*second), chunk=16, initial_state=js1)
    np.testing.assert_allclose(y2.numpy(), np.asarray(jy2), **TOL)


@pytest.mark.parametrize("t", [37, 100])
def test_ssd_ragged_chunk_equals_t(t):
    """The model's setting for a prompt that is no multiple of the chunk:
    chunk = t, one chunk (the reference's twin and kernel at that chunk), and
    a smaller chunk whose padded tail (dt = 0, x = 0) is exact."""
    arrays = _inputs(2, t, 4, 8, 16, seed=t)
    want, ws = jops.ssd_jnp(*_j(*arrays), chunk=t, return_final_state=True)
    kern = jssd(*_j(*arrays), chunk=t)
    for chunk in (t, 16):
        got, gs = ops.ssd(*_t(*arrays), chunk=chunk, return_final_state=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
        np.testing.assert_allclose(got.numpy(), np.asarray(kern), **TOL)


def test_ssd_decode_step_matches_reference():
    rng = np.random.default_rng(10)
    b, h, p, n, g = 2, 4, 8, 16, 2
    state = rng.standard_normal((b, h, p, n)).astype(np.float32)
    xt = rng.standard_normal((b, h, p)).astype(np.float32)
    dtt = np.log1p(np.exp(rng.standard_normal((b, h)))).astype(np.float32)
    A = -np.exp(rng.standard_normal(h) * 0.3).astype(np.float32)
    Bt, Ct = (rng.standard_normal((b, g, n)).astype(np.float32) for _ in range(2))
    ws, wy = jops.ssd_decode_step(*_j(state, xt, dtt, A, Bt, Ct))
    gs, gy = ops.ssd_decode_step(*_t(state, xt, dtt, A, Bt, Ct))
    np.testing.assert_allclose(gs.numpy(), np.asarray(ws), **TOL)
    np.testing.assert_allclose(gy.numpy(), np.asarray(wy), **TOL)


def test_cpu_wrapper_returns_the_plain_version_and_launches_nothing():
    arrays = _t(*_inputs(1, 48, 2, 8, 16, seed=11))
    before = kernels.launch_counts()
    a = tss.ssd_scan(*arrays, chunk=16, return_final_state=True)
    b = tss.ssd_torch(*arrays, chunk=16, return_final_state=True)
    for x, y in zip(a, b):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.ssd(*arrays, chunk=16, impl="cuda")
