"""repro_torch's RG-LRU recurrence (ops.rglru_scan's plain version beside the
rglru_scan CUDA kernel) and RG-LRU block against the reference: its Pallas
rglru_scan in interpret mode, its sequential oracle (ref.rglru), and
``repro.models.rglru``'s apply_rglru / apply_rglru_decode, plus the GeGLU MLP.

The same numpy inputs, made from a seed, go through both packages. The
kernel-level cases are the reference's (tests/test_kernels_lm.py): shapes
(2, 32, 16) and (1, 64, 128), chunk 8 and 16 on the Pallas side, state
chaining over two halves, with its tolerance rtol 2e-4 / atol 2e-5 (a
log-depth scan and a sequential loop round differently); the port also takes
a ragged T (37), which the Pallas kernel refuses. The block-level cases run
on bridged rg-smoke parameters in f32 within 1e-5 (the same operations in
the same order: only the matmul summation order differs).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref
from repro.kernels.rglru_scan import rglru_scan as jrglru
from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import rglru as jrg
from repro_torch.kernels import ops
from repro_torch.models import from_jax_params, get_config
from repro_torch.models import layers as tlayers
from repro_torch.models import rglru as trg

TOL = dict(rtol=2e-4, atol=2e-5)
BLOCK_TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(b, t, w, seed=11):
    """x, the two gate pre-activations, a_param, and the decay / input terms
    precomputed as the reference's model does (a, bterm)."""
    rng = np.random.default_rng(seed)
    x, ig, ag = (rng.standard_normal((b, t, w)).astype(np.float32) for _ in range(3))
    ap = rng.standard_normal(w).astype(np.float32)
    sig = lambda v: 1.0 / (1.0 + np.exp(-v))
    a = np.exp(-8.0 * np.log1p(np.exp(ap))[None, None, :] * sig(ag)).astype(np.float32)
    bterm = (np.sqrt(np.maximum(1 - a * a, 1e-12)) * (sig(ig) * x)).astype(np.float32)
    return x, ig, ag, ap, a, bterm


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("shape", [(2, 32, 16), (1, 64, 128)])
def test_rglru_matches_pallas_kernel_and_oracle(chunk, shape):
    x, ig, ag, ap, a, bterm = _inputs(*shape)
    got, hf = ops.rglru_scan(*_t(a, bterm), return_final_state=True, impl="torch")
    want, want_hf = jrglru(jnp.asarray(a), jnp.asarray(bterm), chunk=chunk,
                           return_final_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf), **TOL)
    oracle = ref.rglru(*(jnp.asarray(v) for v in (x, ig, ag, ap)))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("shape", [(2, 32, 16), (1, 64, 128)])
def test_rglru_initial_state_and_chaining(chunk, shape):
    """With an initial state, against the Pallas kernel's h0 and the oracle's;
    two halves chained through the final state equal one run."""
    x, ig, ag, ap, a, bterm = _inputs(*shape, seed=12)
    h0 = np.random.default_rng(13).standard_normal((shape[0], shape[2])).astype(np.float32)
    got = ops.rglru_scan(*_t(a, bterm), initial_state=torch.from_numpy(h0), impl="torch")
    want = jrglru(jnp.asarray(a), jnp.asarray(bterm), chunk=chunk,
                  initial_state=jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    oracle = ref.rglru(*(jnp.asarray(v) for v in (x, ig, ag, ap)),
                       initial_state=jnp.asarray(h0))
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **TOL)
    half = shape[1] // 2
    ta, tb = _t(a, bterm)
    y1, h1 = ops.rglru_scan(ta[:, :half], tb[:, :half], return_final_state=True, impl="torch")
    y2 = ops.rglru_scan(ta[:, half:], tb[:, half:], initial_state=h1, impl="torch")
    full = ops.rglru_scan(ta, tb, impl="torch")
    np.testing.assert_allclose(torch.cat([y1, y2], 1).numpy(), full.numpy(), **TOL)


@pytest.mark.parametrize("t", [1, 2, 37])
def test_rglru_ragged_t_matches_oracle(t):
    """Any T (the Pallas kernel asserts T % chunk == 0; the port's kernel and
    plain version need no padding): y and the final state against the
    sequential oracle, with and without an initial state."""
    x, ig, ag, ap, a, bterm = _inputs(2, t, 24, seed=t)
    h0 = np.random.default_rng(14).standard_normal((2, 24)).astype(np.float32)
    for init in (None, h0):
        kw = {} if init is None else {"initial_state": jnp.asarray(init)}
        want, want_hf = ref.rglru(*(jnp.asarray(v) for v in (x, ig, ag, ap)),
                                  return_final_state=True, **kw)
        got, hf = ops.rglru_scan(
            *_t(a, bterm), initial_state=None if init is None else torch.from_numpy(init),
            return_final_state=True, impl="torch")
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        np.testing.assert_allclose(hf.numpy(), np.asarray(want_hf), **TOL)


def test_rglru_keeps_the_dtype_and_dispatches_on_the_device():
    """y in a's dtype, the final state in f32; "auto" on CPU tensors is the
    plain version; "cuda" refuses CPU tensors."""
    _, _, _, _, a, bterm = _inputs(1, 8, 16)
    ta, tb = (v.to(torch.bfloat16) for v in _t(a, bterm))
    y, hf = ops.rglru_scan(ta, tb, return_final_state=True)
    assert y.dtype == torch.bfloat16 and hf.dtype == torch.float32
    want = ops.rglru_scan(ta.float(), tb.float(), impl="torch")
    torch.testing.assert_close(y, want.to(torch.bfloat16), rtol=0, atol=0)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru_scan(ta, tb, impl="cuda")


# ---------------------------------------------------------------------------------
# the block, on bridged rg-smoke parameters
# ---------------------------------------------------------------------------------
@pytest.fixture(scope="module")
def rec_params():
    """The first group's rec0 parameters of the reference's rg-smoke model
    (f32), as (cfg, reference params, port params)."""
    cfg_j = dataclasses.replace(jax_get_config("recurrentgemma-2b", smoke=True), dtype="float32")
    params_j = jax_build(cfg_j).init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True), dtype="float32")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    pj = jax.tree.map(lambda v: v[0], params_j["blocks"][0]["rec0"])
    return cfg_j, cfg, pj, params["blocks"][0][0]["rec0"]


def test_apply_rglru_matches_reference(rec_params):
    """Prefill: the output and the decode cache {"h", "conv"}."""
    cfg_j, cfg, pj, pt = rec_params
    x = np.random.default_rng(15).standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    want, cj = jrg.apply_rglru(cfg_j, pj["rec"], jnp.asarray(x), return_state=True)
    got, ct = trg.apply_rglru(cfg, pt["rec"], torch.from_numpy(x), return_state=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
    for name in ("h", "conv"):
        assert ct[name].dtype == torch.float32
        np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), **BLOCK_TOL)


def test_apply_rglru_decode_matches_reference(rec_params):
    """Three decode steps from a random cache: outputs and the cache, which
    the port updates in place."""
    cfg_j, cfg, pj, pt = rec_params
    rng = np.random.default_rng(16)
    w, k = cfg.lru_width, cfg.conv_kernel
    cj = {"h": jnp.asarray(rng.standard_normal((2, w)).astype(np.float32)),
          "conv": jnp.asarray(rng.standard_normal((2, k - 1, w)).astype(np.float32))}
    ct = {n: torch.from_numpy(np.array(v)) for n, v in cj.items()}
    for step in range(3):
        x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
        want, cj = jrg.apply_rglru_decode(cfg_j, pj["rec"], jnp.asarray(x), cj, step)
        got, same = trg.apply_rglru_decode(cfg, pt["rec"], torch.from_numpy(x), ct, step)
        assert same is ct
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
        for name in ("h", "conv"):
            np.testing.assert_allclose(ct[name].numpy(), np.asarray(cj[name]), **BLOCK_TOL)


def test_geglu_mlp_matches_reference(rec_params):
    """GeGLU with jax.nn.gelu's default tanh approximation, same leaf names
    as SwiGLU."""
    cfg_j, cfg, pj, pt = rec_params
    assert cfg.mlp_act == "geglu" and sorted(pt["mlp"]) == ["w_down", "w_gate", "w_up"]
    x = np.random.default_rng(17).standard_normal((2, 5, cfg.d_model)).astype(np.float32)
    want = jlayers.apply_mlp(cfg_j, pj["mlp"], jnp.asarray(x))
    got = tlayers.apply_mlp(cfg, pt["mlp"], torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **BLOCK_TOL)
