"""repro_torch's RG-LRU recurrence at recurrentgemma-2b's width: the plain
``rglru_torch`` (what the rglru_scan kernel is held against on the card) at
B 2, T 256, W 2560, with and without an initial state, against the
reference's Pallas ``rglru_scan`` in interpret mode (chunk 128) and its
sequential oracle ``ref.rglru``.

The same numpy inputs, made from a seed, go through both packages; a and b
are the reference model's decay and input terms of random gates. Tolerance:
tests/test_torch_rglru.py's rtol 2e-4 / atol 2e-5 (a log-depth scan against a
sequential loop).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref
from repro.kernels.rglru_scan import rglru_scan as jrglru
from repro_torch.kernels import rglru_scan as rs

TOL = dict(rtol=2e-4, atol=2e-5)
B, T, W = 2, 256, 2560  # recurrentgemma-2b's width (lru_width = d_model)


def _inputs(seed):
    """x, the two gate pre-activations, a_param, and a, b as the reference's
    model computes them."""
    rng = np.random.default_rng(seed)
    x, ig, ag = (rng.standard_normal((B, T, W)).astype(np.float32) for _ in range(3))
    ap = rng.standard_normal(W).astype(np.float32)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    a = np.exp(-8.0 * np.log1p(np.exp(ap))[None, None, :] * sig(ag)).astype(np.float32)
    bterm = (np.sqrt(np.maximum(1 - a * a, 1e-12)) * (sig(ig) * x)).astype(np.float32)
    return x, ig, ag, ap, a, bterm


@pytest.mark.parametrize("initial", [False, True], ids=["zero_state", "initial_state"])
def test_rglru_torch_at_recurrentgemma_width(initial):
    x, ig, ag, ap, a, bterm = _inputs(31 + initial)
    h0 = np.random.default_rng(37).standard_normal((B, W)).astype(np.float32) if initial else None
    got, hf = rs.rglru_torch(torch.from_numpy(a), torch.from_numpy(bterm),
                             None if h0 is None else torch.from_numpy(h0),
                             return_final_state=True)
    kw = {} if h0 is None else {"initial_state": jnp.asarray(h0)}
    want, want_hf = jrglru(jnp.asarray(a), jnp.asarray(bterm), chunk=128,
                           return_final_state=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf), **TOL)
    oracle, oracle_hf = ref.rglru(*(jnp.asarray(v) for v in (x, ig, ag, ap)),
                                  return_final_state=True, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(oracle_hf), **TOL)
