"""The SSD scan's backward on the CPU: ``ssd_scan.ssd_bwd_torch`` (the plain
twin of the ssd_scan_bwd kernels, the chunked dual of the forward) and
``ssd_scan.SSDScanFn`` (the autograd Function the card trains through; on CPU
tensors its forward and backward are the plain versions).

- ``torch.autograd.gradcheck`` of SSDScanFn in f64 at tiny sizes: a ragged
  t, an initial state, the final state's gradient, one and three chunks.
- The twin against ``torch.autograd`` of ``ssd_torch`` in f32 (each gradient
  within 1e-5 of its max-abs: the same products summed in other orders; dA,
  a sum over every (sequence, step) whose terms cancel, within 5e-5).
- The twin against ``jax.grad`` of the reference's ``ssd_jnp`` on the same
  numpy inputs from a seed (each gradient within 1e-4 of its max-abs).
- The folds of dB / dC over the heads of a head group, over the groups and
  of dA over (sequence, chunk): in index order, bit for bit, and a reversed
  order gives other bits.
- ``ops.ssd`` routes to SSDScanFn under grad where it would launch the
  kernel (the device check mocked), and the mamba2 smoke model's loss and
  gradients through that route against ``jax.value_and_grad`` of the
  reference's (test_torch_train_step's weights and tolerances).
"""
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ops as jops  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import ssd_scan as ss  # noqa: E402

NAMES = ("dx", "ddt", "dA", "dB", "dC", "d_initial_state")


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread a test: these tiny tensors gain nothing from more,
    and beside other test processes the thread pool's waits cost minutes
    (the f64 gradient checks run thousands of small ops)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _inputs(b, t, h, p, n, seed, g=1):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    x = f(b, t, h, p) * 0.5
    dt = np.log1p(np.exp(f(b, t, h))).astype(np.float32)  # softplus
    A = -np.exp(f(h) * 0.3).astype(np.float32)
    B, C = f(b, t, g, n) * 0.3, f(b, t, g, n) * 0.3
    s0 = f(b, h, p, n) * 0.2
    dy, dsf = f(b, t, h, p), f(b, h, p, n) * 0.5
    return x, dt, A, B, C, s0, dy, dsf


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dtype) for a in arrays]


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("t,p,initial", [(37, 3, True), (130, 2, True), (70, 3, False)])
def test_ssd_scan_fn_gradcheck_f64(t, p, initial):
    x, dt, A, B, C, s0, _, _ = _t(_inputs(1, t, 2, p, 3, seed=t), torch.float64)
    ins = [x, dt, A, B, C] + ([s0] if initial else [])
    for a in ins:
        a.requires_grad_()

    def fn(*args):
        return ss.SSDScanFn.apply(*args[:5], args[5] if initial else None)

    # three chunks: the fast mode's random projections (full Jacobians below)
    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-7, rtol=1e-5,
                                    fast_mode=t > 128)


@pytest.mark.parametrize("initial,final_grad", [(True, True), (False, False), (True, False)])
@pytest.mark.parametrize("shape", [(2, 130, 4, 16, 32), (1, 64, 3, 8, 16), (2, 20, 2, 4, 8)])
def test_twin_matches_autograd_of_ssd_torch(shape, initial, final_grad):
    x, dt, A, B, C, s0, dy, dsf = _t(_inputs(*shape, seed=sum(shape)))
    ins = [a.clone().requires_grad_() for a in (x, dt, A, B, C, s0)]
    y, sf = ss.ssd_torch(*ins[:5], initial_state=ins[5] if initial else None,
                         return_final_state=True)
    loss = (y * dy).sum() + ((sf * dsf).sum() if final_grad else 0.0)
    want = torch.autograd.grad(loss, ins if initial else ins[:5])
    got = ss.ssd_bwd_torch(x, dt, A, B, C, dy, initial_state=s0 if initial else None,
                           d_final_state=dsf if final_grad else None)
    assert (got[5] is None) == (not initial)
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        tol = 5e-5 if name == "dA" else 1e-5
        assert _rel(g, w) <= tol, (name, _rel(g, w))


@pytest.mark.parametrize("initial", [True, False])
@pytest.mark.parametrize("shape", [(2, 128, 4, 16, 32), (1, 64, 8, 8, 16)])
def test_twin_matches_jax_grad_of_ssd_jnp(shape, initial):
    arrays = _inputs(*shape, seed=3 + sum(shape))
    x, dt, A, B, C, s0, dy, dsf = arrays

    def loss(x, dt, A, B, C, s0):
        y, sf = jops.ssd_jnp(x, dt, A, B, C, chunk=64, initial_state=s0 if initial else None,
                             return_final_state=True)
        return jnp.sum(y * dy) + jnp.sum(sf * dsf)

    want = jax.grad(loss, argnums=tuple(range(6 if initial else 5)))(
        *(jnp.asarray(a) for a in (x, dt, A, B, C, s0)))
    tx, tdt, tA, tB, tC, ts0, tdy, tdsf = _t(arrays)
    got = ss.ssd_bwd_torch(tx, tdt, tA, tB, tC, tdy, initial_state=ts0 if initial else None,
                           d_final_state=tdsf)
    for name, g, w in zip(NAMES, got, want):
        w = torch.from_numpy(np.array(w))
        assert g.shape == w.shape, name
        assert _rel(g, w) <= 1e-4, (name, _rel(g, w))


def test_twin_folds_heads_and_chunks_in_order(monkeypatch):
    """The kernels' schedule: dCB and dB / dC's per-head terms are folded over
    the heads of each head group in head order (16 heads in groups of 3, the
    last group short), the group partials over the groups in order, and dA
    over its (sequence, chunk) partials in order: every fold bit for bit, the
    returned dA / dB / dC the last folds' sums, and the reversed order gives
    other bits."""
    seen = []
    real = ss._fold

    def spy(parts, dim):
        out = real(parts, dim)
        seen.append((parts.clone(), dim, out))
        return out

    monkeypatch.setattr(ss, "_fold", spy)
    b, t, h = 2, 2560, 16
    assert ss.bwd_head_groups(b, t, h) == (3, 6)
    x, dt, A, B, C, s0, dy, dsf = _t(_inputs(b, t, h, 8, 16, seed=41))
    _, _, dA, dB, dC, _ = ss.ssd_bwd_torch(x, dt, A, B, C, dy, initial_state=s0,
                                           d_final_state=dsf)
    # dCB, dC's and dB's heads in their groups, dA, then dB's and dC's groups
    assert [(p.shape[d], d) for p, d, _ in seen] == [(3, 4), (3, 5), (3, 5), (b * 40, 0),
                                                     (6, 3), (6, 3)]
    for parts, dim, got in seen:
        k = parts.shape[dim]
        in_order = parts.select(dim, 0)
        for i in range(1, k):
            in_order = in_order + parts.select(dim, i)
        backwards = parts.select(dim, k - 1)
        for i in reversed(range(k - 1)):
            backwards = backwards + parts.select(dim, i)
        assert torch.equal(got, in_order)
        assert not torch.equal(got, backwards)
    for (_, _, last), out in zip(seen[3:], (dA, dB, dC)):
        assert torch.equal(last.reshape(out.shape), out)


# (b, t, h) -> (heads a group, groups): mamba2-780m's training shape, the
# ragged card case, shapes whose group size does not divide h, one chunk, and
# one group of every head
HEAD_GROUPS = {(4, 2048, 48): (10, 5), (2, 389, 48): (2, 24), (3, 4096, 11): (4, 3),
               (2, 2560, 16): (3, 6), (1, 64, 48): (1, 48), (64, 8192, 7): (7, 1)}


@pytest.mark.parametrize("shape", list(HEAD_GROUPS), ids=str)
def test_head_groups_cover_every_head_once(shape):
    """bwd_head_groups: groups of G heads cover the h heads once, only the
    last short; one group leaves no dB / dC partial workspace; the
    workspaces at mamba2-780m's training shape come to 459.8 MB."""
    b, t, h = shape
    hg, groups = ss.bwd_head_groups(b, t, h)
    assert (hg, groups) == HEAD_GROUPS[shape]
    assert (groups - 1) * hg < h <= groups * hg
    ws = ss.bwd_workspace_shapes(b, t, h, 128)
    assert ws["dcb"][2] == groups and (ws["dbp"] is None) == (groups == 1)
    if shape == (4, 2048, 48):
        assert ss.bwd_workspace_bytes(b, t, h, 128) == 459_825_152


def _kernel_route_for_the_scans(monkeypatch):
    """Make ``ops.ssd`` / ``ops.rglru_scan`` take their kernel route on CPU
    tensors (there the wrappers run their plain versions); every other
    dispatcher keeps the real device check."""
    real = ops._want_kernel

    def want(impl, x):
        if sys._getframe(1).f_code.co_name in ("ssd", "rglru_scan"):
            return impl != "torch"
        return real(impl, x)

    monkeypatch.setattr(ops, "_want_kernel", want)


def test_ops_ssd_routes_to_the_function_under_grad(monkeypatch):
    _kernel_route_for_the_scans(monkeypatch)
    x, dt, A, B, C, s0, dy, dsf = _t(_inputs(1, 70, 2, 8, 16, seed=5))
    ins = [a.clone().requires_grad_() for a in (x, dt, A, B, C, s0)]
    calls = ss.ssd_bwd_torch.calls
    y, sf = ops.ssd(*ins[:5], initial_state=ins[5], return_final_state=True)
    assert type(y.grad_fn).__name__ == "SSDScanFnBackward"
    got = torch.autograd.grad((y * dy).sum() + (sf * dsf).sum(), ins)
    assert ss.ssd_bwd_torch.calls == calls + 1
    want = ss.ssd_bwd_torch(x, dt, A, B, C, dy, initial_state=s0, d_final_state=dsf)
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name
    with torch.no_grad():  # serving: the forward alone
        assert ops.ssd(*ins[:5]).grad_fn is None
    y_plain = ops.ssd(*ins[:5], impl="torch")  # the plain path: autograd of its torch ops
    assert type(y_plain.grad_fn).__name__ != "SSDScanFnBackward"
    y_only = ops.ssd(*ins[:5])  # y alone: the final state's gradient stays None
    gx = torch.autograd.grad((y_only * dy).sum(), ins[0])[0]
    torch.testing.assert_close(gx, ss.ssd_bwd_torch(x, dt, A, B, C, dy)[0])


def test_mamba2_loss_and_gradients_through_the_function_match_the_reference(monkeypatch):
    from test_torch_train_step import check_family

    _kernel_route_for_the_scans(monkeypatch)
    calls = ss.ssd_bwd_torch.calls
    check_family("mamba2")
    assert ss.ssd_bwd_torch.calls > calls
