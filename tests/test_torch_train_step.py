"""The port's training step against the JAX package, on the CPU: the loss and
every gradient leaf of ``Model.loss_fn`` against ``jax.value_and_grad`` of
the reference's, for one model of each family (llama3.2, dbrx with its aux
loss, whisper, the vision model with its gates at 0.7, mamba2,
recurrentgemma; this file llama3.2, dbrx and mamba2,
``test_torch_train_step_cross.py`` the others), and cross_entropy with a
mask. ``test_torch_train_state.py``
holds ``make_train_step``'s AdamW state, microbatches and the remat modes,
with these helpers.

The weights are the port's seeded init stacked into the reference's tree
(``test_torch_cross_attention.bridged_pair``: attention projections
rescaled to their fan-in, every vision gate set), the inputs numpy made from
a seed. All f32. Tolerances: the loss within 1e-5; each gradient leaf within
1e-4 of its own max-abs (plus 1e-7: leaves that are all but zero), since the
two packages sum the same products in other orders.
"""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro_torch.core.tree import tree_leaves, tree_map  # noqa: E402
from repro_torch.models import to_jax_layout  # noqa: E402
from test_torch_cross_attention import bridged_pair, context_inputs  # noqa: E402

FAMILIES = {"llama": "llama3.2-1b", "dbrx": "dbrx-132b", "whisper": "whisper-large-v3",
            "vision": "llama-3.2-vision-90b", "mamba2": "mamba2-780m",
            "recurrentgemma": "recurrentgemma-2b"}
B, T = 2, 16
LOSS_TOL = 1e-5
GRAD_TOL = 1e-4
_PAIRS = {}


def _pair(name):
    if name not in _PAIRS:
        _PAIRS[name] = bridged_pair(FAMILIES[name], seed=0)
    return _PAIRS[name]


def _batch(cfg, seed=0, batch=B):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab, (batch, T + 1)).astype(np.int32)}
    if cfg.family in ("encdec", "vlm"):
        out.update(context_inputs(cfg, batch, seed=seed))
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def assert_tree_close(got_np, want, rtol, what, floor=1e-7):
    """Each leaf: max |got - want| <= rtol * max |want| + floor."""
    got_l, want_l = jax.tree.leaves(got_np), jax.tree.leaves(want)
    paths = [jax.tree_util.keystr(p) for p, _ in jax.tree_util.tree_leaves_with_path(want)]
    assert len(got_l) == len(want_l), (what, len(got_l), len(want_l))
    for p, g, w in zip(paths, got_l, want_l):
        g, w = np.asarray(g, np.float32), np.asarray(w, np.float32)
        assert g.shape == w.shape, (what, p, g.shape, w.shape)
        tol = rtol * float(np.abs(w).max(initial=0.0)) + floor
        err = float(np.abs(g - w).max(initial=0.0))
        assert err <= tol, (what, p, err, tol)


def _port_grads(model, params, batch, **kw):
    leaves = tree_leaves(params)
    live = [t.detach().clone().requires_grad_() for t in leaves]
    it = iter(live)
    tracked = tree_map(lambda _: next(it), params)
    loss, parts = model.loss_fn(tracked, batch, **kw)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(g if g is not None else torch.zeros_like(t) for g, t in zip(grads, live))
    parts = {k: v.detach() if isinstance(v, torch.Tensor) else v for k, v in parts.items()}
    return loss.detach(), parts, tree_map(lambda _: next(it), params)


def check_family(family):
    """The loss, the aux loss and every gradient leaf of ``family`` against
    the reference's."""
    cfg, model_j, params_j, model, params = _pair(family)
    batch = _batch(cfg, seed=1)
    (loss_j, parts_j), grads_j = jax.value_and_grad(
        lambda p: model_j.loss_fn(p, _jax_batch(batch)), has_aux=True)(params_j)
    loss, parts, grads = _port_grads(model, params, _torch_batch(batch))
    assert abs(float(loss) - float(loss_j)) <= LOSS_TOL * max(1.0, abs(float(loss_j)))
    assert abs(float(parts["aux"]) - float(parts_j["aux"])) <= LOSS_TOL * max(
        1.0, abs(float(parts_j["aux"])))
    if family == "dbrx":
        assert float(parts_j["aux"]) > 0  # the router's aux loss is in the total
    assert_tree_close(to_jax_layout(grads, cfg), grads_j, GRAD_TOL, family)


@pytest.mark.parametrize("family", ["dbrx", "llama", "mamba2"])
def test_loss_and_gradients_match_the_reference(family):
    check_family(family)


def test_cross_entropy_mask_matches_the_reference():
    from repro.models.layers import cross_entropy as jce
    from repro_torch.models.layers import cross_entropy

    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 7, 40)).astype(np.float32)
    labels = rng.integers(0, 40, (2, 7)).astype(np.int32)
    for mask in (None, (rng.random((2, 7)) < 0.6).astype(np.float32), np.zeros((2, 7), np.float32)):
        want = float(jce(jnp.asarray(logits), jnp.asarray(labels),
                         None if mask is None else jnp.asarray(mask)))
        got = float(cross_entropy(torch.from_numpy(logits), torch.from_numpy(labels),
                                  None if mask is None else torch.from_numpy(mask)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want))
