"""The port's ``make_train_step`` against the reference's, on the CPU, in
f32 on llama3.2-smoke (and dbrx-smoke for remat): AdamW's m and v after 1
and 3 steps with f32 and int8 moments, the loss and grad norm, the params
after a step, two microbatches against the reference's and against one
batch, and the remat modes (off, on, "nothing", "dots") giving equal
gradients. Weights and batches as ``test_torch_train_step.py``'s.

Tolerances: m after a step within 1e-5 of m's max-abs, v within 1e-4 of
v's max-abs (it is a square of the gradient); the int8 moments' dequantized
values within k quantization steps (scales) of each other after k steps, at
most 0.1% of them apart at all: a rounding near a half step may go either
way, and b1 carries that step into the next one, where it may meet another.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core.distributed import tree_initialize  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import constant as jconstant  # noqa: E402
from repro.train import TrainProfile as JProfile  # noqa: E402
from repro.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.models import to_jax_layout  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, constant  # noqa: E402
from repro_torch.train import TrainProfile, make_train_step  # noqa: E402
from test_torch_train_step import (  # noqa: E402
    LOSS_TOL,
    _batch,
    _jax_batch,
    _pair,
    _port_grads,
    _torch_batch,
    assert_tree_close,
)


def _steps(int8, steps, family="llama", micro=1, lr=1e-3):
    """``steps`` train steps in both packages from the same weights and
    batches: (the port's params / state / metrics, the reference's)."""
    cfg, model_j, params_j, model, params = _pair(family)
    opt = AdamWConfig(lr=constant(lr), int8_state=int8, state_block=32)
    opt_j = JAdamW(lr=jconstant(lr), int8_state=int8, state_block=32)
    step, _, state_specs = make_train_step(model, opt, TrainProfile(num_microbatches=micro))
    step_j, _, state_specs_j = jax_make_train_step(model_j, opt_j,
                                                   JProfile(num_microbatches=micro))
    state = adamw_init(state_specs, "cpu")
    state_j = tree_initialize(state_specs_j, jax.random.key(1))
    step_j = jax.jit(step_j)
    metrics = metrics_j = None
    for i in range(steps):
        batch = _batch(cfg, seed=10 + i, batch=4)
        params, state, metrics = step(params, state, _torch_batch(batch))
        params_j, state_j, metrics_j = step_j(params_j, state_j, _jax_batch(batch))
    return (params, state, metrics), (params_j, state_j, metrics_j), cfg


def _moments(state, cfg):
    return {"m": to_jax_layout(state["m"], cfg), "v": to_jax_layout(state["v"], cfg)}


def _dequant_tree(tree, block):
    """{"q", "scale"} leaves -> f32 values; f32 leaves as they are."""
    def deq(x):
        if isinstance(x, dict):
            q, s = np.asarray(x["q"], np.float32), np.asarray(x["scale"], np.float32)
            return (q.reshape(*q.shape[:-1], -1, block) * s[..., None]).reshape(q.shape), \
                np.repeat(s, block, axis=-1)
        return np.asarray(x), None

    return jax.tree.map(deq, tree, is_leaf=lambda x: isinstance(x, dict) and "q" in x)


@pytest.mark.parametrize("steps", [1, 3])
@pytest.mark.parametrize("int8", [False, True], ids=["f32", "int8"])
def test_adamw_state_after_steps_matches_the_reference(int8, steps):
    (p, s, m), (pj, sj, mj), cfg = _steps(int8, steps)
    assert int(s["step"]) == int(sj["step"]) == steps
    assert abs(float(m["loss"]) - float(mj["loss"])) <= LOSS_TOL * abs(float(mj["loss"]))
    assert abs(float(m["grad_norm"]) - float(mj["grad_norm"])) <= 1e-4 * float(mj["grad_norm"])
    got = _moments(s, cfg)
    if not int8:
        assert_tree_close(got["m"], sj["m"], 1e-5, "m")
        assert_tree_close(got["v"], sj["v"], 1e-4, "v")
        return
    # the same leaves quantized; dequantized values within one step of each other
    is_q = lambda x: isinstance(x, dict) and "q" in x  # noqa: E731
    kinds = jax.tree.map(lambda x: is_q(x), got["m"], is_leaf=is_q)
    assert kinds == jax.tree.map(lambda x: is_q(x), jax.tree.map(np.asarray, sj["m"]), is_leaf=is_q)
    assert any(jax.tree.leaves(kinds))
    for name in ("m", "v"):
        a = jax.tree.leaves(_dequant_tree(got[name], 32), is_leaf=lambda x: isinstance(x, tuple))
        b = jax.tree.leaves(_dequant_tree(jax.tree.map(np.asarray, sj[name]), 32),
                            is_leaf=lambda x: isinstance(x, tuple))
        flips = total = 0
        for (va, sa), (vb, sb) in zip(a, b):
            if sa is None:
                tol = 1e-4 * float(np.abs(vb).max(initial=0.0)) + 1e-7
                assert float(np.abs(va - vb).max(initial=0.0)) <= tol, name
                continue
            steps_apart = np.abs(va - vb) / np.maximum(sa, sb)
            assert float(steps_apart.max()) <= steps * 1.001, (name, float(steps_apart.max()))
            flips += int((steps_apart > 0.5).sum())
            total += steps_apart.size
        assert flips <= 1e-3 * total, (name, flips, total)


def test_params_after_a_step_follow_the_reference():
    """Adam's first update is about lr * sign(g): where |g| is near 0 the two
    packages' gradients may differ in sign, so the new params are held only
    where |g| > 1e-3 * max|g| of their leaf (and within 1e-6 + 1e-5 |p|)."""
    cfg, model_j, params_j, model, params = _pair("llama")
    (p, _, _), (pj, _, _), _ = _steps(False, 1)
    batch = _batch(cfg, seed=10, batch=4)
    _, grads_j = jax.value_and_grad(lambda q: model_j.loss_fn(q, _jax_batch(batch))[0])(params_j)
    got = to_jax_layout(p, cfg)
    checked = 0
    for a, b, g in zip(jax.tree.leaves(got), jax.tree.leaves(pj), jax.tree.leaves(grads_j)):
        a, b, g = np.asarray(a), np.asarray(b), np.abs(np.asarray(g))
        sure = g > 1e-3 * g.max(initial=0.0)
        checked += int(sure.sum())
        np.testing.assert_allclose(a[sure], b[sure], rtol=1e-5, atol=1e-6)
    assert checked > 0.5 * sum(np.size(x) for x in jax.tree.leaves(pj))


def test_two_microbatches_match_the_reference_and_one_batch():
    (p2, s2, m2), (pj2, sj2, mj2), cfg = _steps(False, 1, micro=2)
    assert abs(float(m2["loss"]) - float(mj2["loss"])) <= LOSS_TOL * abs(float(mj2["loss"]))
    assert_tree_close(_moments(s2, cfg)["m"], sj2["m"], 1e-5, "m, 2 microbatches")
    (p1, s1, m1), _, _ = _steps(False, 1, micro=1)
    # the mean of two half-batch means is the whole batch's mean here (equal halves)
    assert abs(float(m2["loss"]) - float(m1["loss"])) <= 1e-5 * abs(float(m1["loss"]))
    assert_tree_close(_moments(s2, cfg)["m"], _moments(s1, cfg)["m"], 1e-5, "m, 2 vs 1")


@pytest.mark.parametrize("family", ["llama", "dbrx"])
def test_remat_modes_give_equal_gradients(family):
    cfg, _, _, model, params = _pair(family)
    batch = _torch_batch(_batch(cfg, seed=2))
    ref = None
    for remat, policy in ((False, None), (True, None), (True, "nothing"), (True, "dots")):
        loss, _, grads = _port_grads(model, params, batch, remat=remat, remat_policy=policy)
        leaves = [g.clone() for g in tree_leaves(grads)]
        if ref is None:
            ref = (float(loss), leaves)
            continue
        assert float(loss) == ref[0]
        for a, b in zip(leaves, ref[1]):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7)


def test_remat_policy_is_checked():
    cfg, _, _, model, params = _pair("llama")
    with pytest.raises(ValueError, match="remat_policy"):
        _port_grads(model, params, _torch_batch(_batch(cfg)), remat_policy="everything")
