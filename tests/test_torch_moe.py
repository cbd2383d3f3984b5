"""The MoE block and layernorm of repro_torch held against the JAX package.

``apply_moe`` runs on parameters made by the reference (``tree_initialize``
of its ``moe_specs``) and bridged across, on the same numpy inputs: outputs
and aux agree within 1e-5 in f32 and 2e-2 in bf16 (the gate-weighted
k-sum runs in bf16 in both, in different orders). Cases: dbrx-smoke and
kimi-smoke; a capacity factor small enough that entries are dropped (the
drop is asserted); rows whose normed input is constant (a zero router row:
all E experts tie, the lower ids win); int8 experts dequantized by ``_deq``.
The reference's ``apply_moe`` runs under ``jax.jit`` (the same function,
compiled once instead of op by op). Padding and inactive rows taking
capacity are held in test_torch_moe_models.py, through the paged steps.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.accessors import QuantizedAccessor as JaxQuantizedAccessor
from repro.core.distributed import tree_initialize
from repro.models import get_config as jax_get_config
from repro.models import layers as jax_layers
from repro.models import moe as jax_moe
from repro_torch.kernels import ops
from repro_torch.models import get_config, layers, moe

F32_TOL = dict(rtol=1e-5, atol=1e-5)
BF16_TOL = dict(rtol=2e-2, atol=2e-2)
ARCHS = ("dbrx-132b", "kimi-k2-1t-a32b")


def _cfgs(arch, dtype="float32", **kw):
    return (dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dtype, **kw),
            dataclasses.replace(get_config(arch, smoke=True), dtype=dtype, **kw))


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    a = np.array(tree)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _params(cfg_j, quantized=False, seed=0):
    quant = JaxQuantizedAccessor(cfg_j.param_dtype, bits=8, block=128) if quantized else None
    pj = tree_initialize(jax_moe.moe_specs(cfg_j, quant=quant), jax.random.key(seed))
    return pj, _to_torch(pj)


def _input(cfg, shape, dtype, seed=1):
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.from_numpy(x).to(getattr(torch, dtype))


_jax_apply_moe = jax.jit(jax_moe.apply_moe, static_argnums=0)


def _run(cfg_j, cfg, pj, pt, xj, xt):
    yj, auxj = _jax_apply_moe(cfg_j, pj, xj)
    y, aux = moe.apply_moe(cfg, pt, xt)
    assert y.shape == xt.shape and y.dtype == xt.dtype and aux.dtype == torch.float32
    return (np.asarray(yj.astype(jnp.float32)), float(auxj)), (y.float().numpy(), float(aux))


def _dropped(cfg, router, x):
    """(token, choice) entries past their expert's capacity under the port's
    routing of ``x``."""
    t = x.shape[0] * x.shape[1]
    probs = torch.softmax(x.reshape(t, -1).float() @ router.float(), -1)
    counts = torch.bincount(ops.top_k_lower_id_first(probs, cfg.top_k)[1].reshape(-1),
                            minlength=cfg.n_experts)
    return t * cfg.top_k - sum(min(int(n), moe._capacity(cfg, t)) for n in counts)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_reference(arch, dtype):
    cfg_j, cfg = _cfgs(arch, dtype)
    pj, pt = _params(cfg_j)
    xj, xt = _input(cfg, (2, 12, cfg.d_model), dtype)
    (yj, auxj), (y, aux) = _run(cfg_j, cfg, pj, pt, xj, xt)
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    np.testing.assert_allclose(y, yj, **tol)
    np.testing.assert_allclose(aux, auxj, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_drops_past_capacity(arch):
    cfg_j, cfg = _cfgs(arch, capacity_factor=0.25)
    pj, pt = _params(cfg_j, seed=2)
    xj, xt = _input(cfg, (2, 16, cfg.d_model), "float32", seed=3)
    assert _dropped(cfg, pt["router"], xt) > 0
    (yj, auxj), (y, aux) = _run(cfg_j, cfg, pj, pt, xj, xt)
    np.testing.assert_allclose(y, yj, **F32_TOL)
    np.testing.assert_allclose(aux, auxj, rtol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_all_experts_tie(arch):
    """A zero input row (a layernorm of a constant row) has a zero router
    row: softmax is uniform, every expert ties and ids 0..k-1 win, with equal
    gates; other rows in the same batch route normally."""
    cfg_j, cfg = _cfgs(arch)
    pj, pt = _params(cfg_j, seed=4)
    x = np.random.default_rng(5).standard_normal((1, 8, cfg.d_model)).astype(np.float32)
    x[0, [0, 3, 7]] = 0.0
    (yj, auxj), (y, aux) = _run(cfg_j, cfg, pj, pt, jnp.asarray(x), torch.from_numpy(x))
    np.testing.assert_allclose(y, yj, **F32_TOL)
    np.testing.assert_allclose(aux, auxj, rtol=1e-5)
    probs = torch.softmax(torch.zeros(1, cfg.n_experts) @ torch.zeros(cfg.n_experts,
                                                                      cfg.n_experts), -1)
    vals, ids = ops.top_k_lower_id_first(probs, cfg.top_k)
    assert ids.tolist() == [list(range(cfg.top_k))]
    assert torch.all(vals == vals[0, 0])


def test_top_k_orders_ties_by_id():
    probs = torch.tensor([[0.1, 0.3, 0.3, 0.0, 0.3], [0.25, 0.25, 0.25, 0.25, 0.0]])
    vals, ids = ops.top_k_lower_id_first(probs, 3)
    assert ids.tolist() == [[1, 2, 4], [0, 1, 2]]
    want_v, want_i = jax.lax.top_k(jnp.asarray(probs.numpy()), 3)
    assert ids.tolist() == np.asarray(want_i).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(want_v))


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_int8_experts(arch):
    """Experts stored int8 {"q", "scale"} along their last dim: the bridged
    bytes dequantize (``_deq``) to the reference's values."""
    cfg_j, cfg = _cfgs(arch)
    pj, pt = _params(cfg_j, quantized=True, seed=6)
    assert all(isinstance(pt[n], dict) for n in ("w_gate", "w_up", "w_down"))
    for n in ("w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(moe._deq(pt[n], cfg).numpy(),
                                      np.asarray(jax_moe._deq(pj[n], cfg_j)))
    xj, xt = _input(cfg, (2, 8, cfg.d_model), "float32", seed=7)
    (yj, auxj), (y, aux) = _run(cfg_j, cfg, pj, pt, xj, xt)
    np.testing.assert_allclose(y, yj, **F32_TOL)
    np.testing.assert_allclose(aux, auxj, rtol=1e-5)


@pytest.mark.parametrize("t", [1, 5, 40])
def test_capacity_matches_reference(t):
    for arch in ARCHS:
        cfg_j, cfg = _cfgs(arch)
        assert moe._capacity(cfg, t) == jax_moe._capacity(cfg_j, t)
        assert moe._capacity(cfg, t) % 8 == 0


def test_moe_specs_match_reference():
    for arch in ARCHS:
        for quantized in (False, True):
            cfg_j, cfg = _cfgs(arch, "bfloat16")
            pj, _ = _params(cfg_j, quantized=quantized)
            quant = (layers.QuantizedAccessor(torch.bfloat16, bits=8, block=128)
                     if quantized else None)
            pt = layers.init_tree(moe.moe_specs(cfg, quant=quant), torch.Generator(), "cpu")
            shapes = jax.tree.map(lambda a: (a.shape, a.dtype.name), pj)
            mine = {k: ({n: (tuple(t.shape), str(t.dtype).split(".")[1]) for n, t in v.items()}
                        if isinstance(v, dict) else (tuple(v.shape), str(v.dtype).split(".")[1]))
                    for k, v in pt.items()}
            assert mine == shapes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layernorm_matches_reference(dtype):
    d = 48
    rng = np.random.default_rng(8)
    x = (rng.standard_normal((3, 5, d)) * 3 + 1).astype(np.float32)
    p = {"scale": rng.standard_normal(d).astype(np.float32),
         "bias": rng.standard_normal(d).astype(np.float32)}
    want = jax_layers.apply_layernorm(jnp.asarray(x).astype(dtype),
                                      {k: jnp.asarray(v) for k, v in p.items()})
    got = layers.apply_layernorm(torch.from_numpy(x).to(getattr(torch, dtype)),
                                 {k: torch.from_numpy(v) for k, v in p.items()})
    assert got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == "float32" else dict(rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)
    specs = layers.layernorm_specs(d)
    assert {k: (s.shape, s.dtype, s.init) for k, s in specs.items()} == {
        "scale": ((d,), torch.float32, "ones"), "bias": ((d,), torch.float32, "zeros")}


def test_norm_dispatch_on_config():
    for arch, want in (("dbrx-132b", dict), ("kimi-k2-1t-a32b", layers.ParamSpec)):
        cfg = get_config(arch, smoke=True)
        assert isinstance(layers.norm_specs(cfg), want)
    x = torch.randn(2, 3, 64)
    cfg = get_config("dbrx-132b", smoke=True)
    p = {"scale": torch.ones(64), "bias": torch.zeros(64)}
    torch.testing.assert_close(layers.apply_norm(cfg, x, p), layers.apply_layernorm(x, p))

