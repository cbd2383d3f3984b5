"""The RG-LRU recurrence's backward on the CPU: ``rglru_scan.rglru_bwd_torch``
(the plain twin of the rglru_scan_bwd kernel: the reverse recurrence Lam_t =
dy_t + a_{t+1} Lam_{t+1}) and ``rglru_scan.RGLRUScanFn`` (the autograd
Function the card trains through; on CPU tensors its forward and backward
are the plain versions).

- ``torch.autograd.gradcheck`` of RGLRUScanFn in f64: a ragged T, an initial
  state, the final state's gradient.
- The twin against ``torch.autograd`` of ``rglru_torch`` in f32 (each
  gradient within 1e-5 of its max-abs).
- The twin against ``jax.grad`` of ``jax.lax.associative_scan`` with the
  reference model's ``combine`` and its fold of h0 into b_0
  (``src/repro/models/rglru.py:83-94``), on the same numpy inputs from a
  seed (within 1e-5 of each gradient's max-abs).
- RGLRUScanFn refuses bf16 a or b (both models feed f32).
- ``ops.rglru_scan`` routes to RGLRUScanFn under grad where it would launch
  the kernel (the device check mocked), and the recurrentgemma smoke model's
  loss and gradients through that route against ``jax.value_and_grad`` of
  the reference's (test_torch_train_step's weights and tolerances).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import rglru_scan as rs  # noqa: E402
from test_torch_ssd_bwd import _kernel_route_for_the_scans, one_thread  # noqa: E402, F401


def _inputs(b, t, w, seed):
    """a in (0, 1) as the model's decay, b, h0, dy and the final state's
    gradient, f32 numpy."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    a = np.exp(-8.0 * np.log1p(np.exp(f(w)))[None, None] / (1 + np.exp(-f(b, t, w))))
    return a.astype(np.float32), f(b, t, w), f(b, w), f(b, t, w), f(b, w)


def _t(arrays, dtype=torch.float32):
    return [torch.from_numpy(np.ascontiguousarray(x)).to(dtype) for x in arrays]


def _rel(got, want):
    return float((got - want).abs().max()) / max(float(want.abs().max()), 1e-30)


@pytest.mark.parametrize("t,initial", [(1, True), (37, True), (33, False)])
def test_rglru_scan_fn_gradcheck_f64(t, initial):
    a, b, h0, _, _ = _t(_inputs(2, t, 3, seed=t), torch.float64)
    ins = [a, b] + ([h0] if initial else [])
    for x in ins:
        x.requires_grad_()

    def fn(*args):
        return rs.RGLRUScanFn.apply(args[0], args[1], args[2] if initial else None)

    assert torch.autograd.gradcheck(fn, ins, eps=1e-6, atol=1e-7, rtol=1e-5)


@pytest.mark.parametrize("initial,final_grad", [(True, True), (False, False), (False, True)])
@pytest.mark.parametrize("shape", [(2, 37, 16), (1, 256, 128), (3, 1, 8)])
def test_twin_matches_autograd_of_rglru_torch(shape, initial, final_grad):
    a, b, h0, dy, dhf = _t(_inputs(*shape, seed=sum(shape)))
    ins = [x.clone().requires_grad_() for x in (a, b, h0)]
    y, hf = rs.rglru_torch(ins[0], ins[1], ins[2] if initial else None, True)
    loss = (y * dy).sum() + ((hf * dhf).sum() if final_grad else 0.0)
    wrt = ins if initial else ins[:2]
    want = [torch.zeros_like(x) if g is None else g  # T 1 without h0: y is b alone
            for x, g in zip(wrt, torch.autograd.grad(loss, wrt, allow_unused=True))]
    got = rs.rglru_bwd_torch(a, y.detach(), dy, initial_state=h0 if initial else None,
                             d_final_state=dhf if final_grad else None)
    assert (got[2] is None) == (not initial)
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


def _combine(lhs, rhs):  # the reference model's (src/repro/models/rglru.py:88)
    al, bl = lhs
    ar, br = rhs
    return al * ar, ar * bl + br


@pytest.mark.parametrize("shape", [(2, 77, 64)])
def test_twin_matches_jax_grad_of_the_associative_scan(shape):
    a, b, h0, dy, dhf = _inputs(*shape, seed=5 + sum(shape))

    def loss(a, b, h0):
        b = b.at[:, 0].add(a[:, 0] * h0)  # the reference's fold of h0 into b_0
        _, h = jax.lax.associative_scan(_combine, (a, b), axis=1)
        return jnp.sum(h * dy) + jnp.sum(h[:, -1] * dhf)

    want = jax.grad(loss, argnums=(0, 1, 2))(jnp.asarray(a), jnp.asarray(b), jnp.asarray(h0))
    ta, tb, th0, tdy, tdhf = _t((a, b, h0, dy, dhf))
    h = rs.rglru_torch(ta, tb, th0)
    got = rs.rglru_bwd_torch(ta, h, tdy, initial_state=th0, d_final_state=tdhf)
    for name, g, w in zip(("da", "db", "dh0"), got, want):
        w = torch.from_numpy(np.array(w))
        assert _rel(g, w) <= 1e-5, (name, _rel(g, w))


def test_function_refuses_bf16_a_and_b():
    a, b, h0, _, _ = _t(_inputs(2, 45, 24, seed=9))
    for a_, b_ in ((a.to(torch.bfloat16), b), (a, b.to(torch.bfloat16)),
                   (a.to(torch.bfloat16), b.to(torch.bfloat16))):
        with pytest.raises(TypeError, match="f32 a and b"):
            rs.RGLRUScanFn.apply(a_, b_, h0)


def test_ops_rglru_scan_routes_to_the_function_under_grad(monkeypatch):
    _kernel_route_for_the_scans(monkeypatch)
    a, b, h0, dy, dhf = _t(_inputs(2, 50, 32, seed=3))
    ins = [x.clone().requires_grad_() for x in (a, b, h0)]
    calls = rs.rglru_bwd_torch.calls
    y, hf = ops.rglru_scan(ins[0], ins[1], initial_state=ins[2], return_final_state=True)
    assert type(y.grad_fn).__name__ == "RGLRUScanFnBackward"
    got = torch.autograd.grad((y * dy).sum() + (hf * dhf).sum(), ins)
    assert rs.rglru_bwd_torch.calls == calls + 1
    want = rs.rglru_bwd_torch(a, y.detach(), dy, initial_state=h0, d_final_state=dhf)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():
        assert ops.rglru_scan(*ins[:2]).grad_fn is None
    assert type(ops.rglru_scan(*ins[:2], impl="torch").grad_fn).__name__ != \
        "RGLRUScanFnBackward"


def test_recurrentgemma_loss_and_gradients_through_the_function_match_the_reference(
        monkeypatch):
    from test_torch_train_step import check_family

    _kernel_route_for_the_scans(monkeypatch)
    calls = rs.rglru_bwd_torch.calls
    check_family("recurrentgemma")
    assert rs.rglru_bwd_torch.calls > calls
