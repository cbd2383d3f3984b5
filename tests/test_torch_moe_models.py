"""The MoE models dbrx-132b and kimi-k2-1t-a32b in repro_torch, held against
the JAX package on bridged weights.

Configs: dbrx-smoke (layernorm, 4 experts top-2), kimi-smoke (rmsnorm, 8
experts top-2, head dim 16), kimi-smoke at head dim 112 (kimi's own), and
dbrx-smoke at capacity factor 0.5, where padding and inactive rows crowd
live ones out of their experts. All f32: the port's own init (seeded),
stacked into the reference's tree, checked against the tree of the
reference's init and bridged back with ``from_jax_params``.

What must agree with the reference within 1e-4: ``forward`` logits and its
aux (the f32 sum of the layers' aux losses); ``prefill`` + ``decode_step``;
``decode_step_paged`` as a chunk step (padded rows routed too), a decode step
(an inactive row routed too) and a speculative verify window, with the
updated pools. The port's prefill + decode against its own forward holds
only at the reference's 2e-1 for the MoE family: capacity depends on the
token count, so prefill (T = B * S) and decode (T = B) drop differently.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import build_model as jax_build, get_config as jax_get_config
from repro_torch.models import (
    ModelConfig, MoEBlock, block_program, build_model, from_jax_params, get_config,
)

TOL = dict(rtol=1e-4, atol=1e-4)
VARIANTS = {
    "dbrx": ("dbrx-132b", {}),
    "kimi": ("kimi-k2-1t-a32b", {}),
    "kimi_d112": ("kimi-k2-1t-a32b", {"d_head": 112}),
    "dbrx_tight": ("dbrx-132b", {"capacity_factor": 0.5}),
}
_MODELS = {}


def bridged_pair(arch, seed, **kw):
    """(cfg, JAX model, JAX params, port model, bridged params) of the f32
    smoke config with ``kw``, on the same weights: the port's init, stacked on
    the layer dim into the reference's tree (its structure, shapes and dtypes
    asserted against the reference's init, traced with ``jax.eval_shape``), and
    bridged back with ``from_jax_params``. The reference's own init draws
    each leaf in a jitted call, seconds a config on the CPU."""
    cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32", **kw)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32", **kw)
    model_j, model = jax_build(cfg_j), build_model(cfg, device="cpu")
    p = model.init_params(torch.Generator().manual_seed(seed))
    np_tree = {
        "embed": jax.tree.map(lambda t: t.numpy(), p["embed"]),
        "blocks": [jax.tree.map(lambda *ls: np.stack([t.numpy() for t in ls]), *layers)
                   for layers in p["blocks"]],
        "final_norm": jax.tree.map(lambda t: t.numpy(), p["final_norm"]),
    }
    params_j = jax.tree.map(jnp.asarray, np_tree)
    ref = jax.eval_shape(model_j.init_params, jax.random.key(seed))
    assert jax.tree.map(lambda a: (a.shape, a.dtype), params_j) == jax.tree.map(
        lambda a: (a.shape, a.dtype), ref)
    return cfg, model_j, params_j, model, from_jax_params(np_tree, cfg, device="cpu")


def _models(variant):
    if variant not in _MODELS:
        arch, kw = VARIANTS[variant]
        _MODELS[variant] = bridged_pair(arch, 0, **kw)
    return _MODELS[variant]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_config_matches_reference(arch, smoke):
    ref = jax_get_config(arch, smoke=smoke)
    cfg = get_config(arch, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    ported = {f.name for f in dataclasses.fields(ModelConfig)}
    for f in dataclasses.fields(type(ref)):
        if f.name not in ported:
            assert getattr(ref, f.name) == f.default, f.name
    assert (cfg.head_dim, cfg.vocab_padded) == (ref.head_dim, ref.vocab_padded)
    assert block_program(cfg) == [("moe", cfg.n_layers)]
    if not smoke:
        want = {"dbrx-132b": (48, 8, 128, 16, 4, "layernorm"),
                "kimi-k2-1t-a32b": (64, 8, 112, 384, 8, "rmsnorm")}[arch]
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.n_experts, cfg.top_k,
                cfg.norm) == want


@pytest.mark.parametrize("variant", ["dbrx", "kimi"])
def test_param_tree_matches_reference(variant):
    """Leaves, shapes and dtypes of the port's own init equal the
    reference's init (traced), layer by layer; the bridge carries the
    layernorm dicts, the f32 router and the 3-D experts value for value."""
    cfg, model_j, params_j, model, params = _models(variant)
    p = model.init_params(torch.Generator().manual_seed(1))
    ref = jax.eval_shape(model_j.init_params, jax.random.key(1))
    shape = lambda t: (tuple(t.shape), str(t.dtype).split(".")[1])
    ref_layer = jax.tree.map(lambda a: (a.shape[1:], a.dtype.name), ref["blocks"][0])
    assert jax.tree.map(shape, p["blocks"][0][0]) == ref_layer
    assert jax.tree.map(shape, p["final_norm"]) == jax.tree.map(
        lambda a: (a.shape, a.dtype.name), ref["final_norm"])
    for l in range(cfg.n_layers):
        for name in ("router", "w_gate", "w_down"):
            np.testing.assert_array_equal(params["blocks"][0][l]["moe"][name].numpy(),
                                          np.asarray(params_j["blocks"][0]["moe"][name])[l])
    if cfg.norm == "layernorm":
        assert set(params["final_norm"]) == {"scale", "bias"}
        assert set(params["blocks"][0][0]["ln_moe"]) == {"scale", "bias"}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_logits_and_aux_match(variant):
    cfg, model_j, params_j, model, params = _models(variant)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 12)).astype(np.int32)
    want, aux_j = model_j.forward(params_j, jnp.asarray(toks), remat=False)
    got, aux = model.forward(params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert aux.dtype == torch.float32 and float(aux) > 0
    np.testing.assert_allclose(float(aux), float(aux_j), rtol=1e-5)


@pytest.mark.parametrize("variant", ["dbrx", "kimi_d112"])
def test_prefill_decode_step_match(variant):
    cfg, model_j, params_j, model, params = _models(variant)
    toks = np.random.default_rng(2).integers(0, cfg.vocab, size=(2, 9)).astype(np.int32)
    want, caches_j = model_j.prefill(params_j, jnp.asarray(toks[:, :8]), max_len=12)
    got, caches = model.prefill(params, torch.from_numpy(toks[:, :8]), max_len=12)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    want, _ = model_j.decode_step(params_j, caches_j, jnp.asarray(toks[:, 8]), 8)
    got, _ = model.decode_step(params, caches, torch.from_numpy(toks[:, 8]), 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _paged_inputs(cfg, rng, batch, max_pages, ps):
    num_pages = batch * max_pages + 1
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, ps, cfg.head_dim)
    pools = {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}
    bt = rng.permutation(np.arange(1, num_pages)).reshape(batch, max_pages).astype(np.int32)
    return pools, bt


def _paged_step(variant, toks, bt, lens, **kw):
    """Both packages' decode_step_paged on the same pools: (logits, pools) each."""
    cfg, model_j, params_j, model, params = _models(variant)
    pools = kw.pop("pools")
    jkw = {k: jnp.asarray(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    want, new_j = model_j.decode_step_paged(
        params_j, [{n: jnp.asarray(a) for n, a in pools.items()}], jnp.asarray(toks),
        jnp.asarray(bt), jnp.asarray(lens), attn_impl="jnp", **jkw)
    tkw = {k: torch.from_numpy(v) if isinstance(v, np.ndarray) else v for k, v in kw.items()}
    caches = [{n: torch.from_numpy(a.copy()) for n, a in pools.items()}]
    got, new = model.decode_step_paged(params, caches, torch.from_numpy(toks),
                                       torch.from_numpy(bt), torch.from_numpy(lens), **tkw)
    assert new[0]["k"] is caches[0]["k"]  # updated in place
    return (got.numpy(), {n: t.numpy() for n, t in new[0].items()}), (
        np.asarray(want), {n: np.asarray(a) for n, a in new_j[0].items()})


def _assert_pools(got, want):
    for n in ("k", "v"):  # page 0 is the null page every masked write lands in
        np.testing.assert_allclose(got[n][:, 1:], want[n][:, 1:], rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_paged_chunk_matches(variant):
    """A chunk per row: one past a resident prefix with an adopted page, one
    cold with 2 padding rows; the padding is routed as the reference routes
    it (at dbrx_tight it crowds live rows out)."""
    cfg = _models(variant)[0]
    rng = np.random.default_rng(3)
    ps, max_pages, batch, c = 4, 5, 2, 8
    pools, bt = _paged_inputs(cfg, rng, batch, max_pages, ps)
    wt = bt.copy()
    wt[0, :1] = 0
    toks = rng.integers(0, cfg.vocab, size=(batch, c)).astype(np.int32)
    (got, new), (want, new_j) = _paged_step(
        variant, toks, bt, np.array([8, 0], np.int32), pools=pools, write_tables=wt,
        n_new=np.array([8, 6], np.int32), last_index=np.array([7, 5], np.int32))
    np.testing.assert_allclose(got, want, **TOL)
    _assert_pools(new, new_j)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_paged_decode_matches(variant):
    """Decode rows at different lengths, one inactive (its table and length
    nulled; its token still routed)."""
    cfg = _models(variant)[0]
    rng = np.random.default_rng(4)
    ps, max_pages, batch = 4, 4, 3
    pools, bt = _paged_inputs(cfg, rng, batch, max_pages, ps)
    toks = rng.integers(0, cfg.vocab, size=batch).astype(np.int32)
    (got, new), (want, new_j) = _paged_step(
        variant, toks, bt, np.array([5, 12, 3], np.int32), pools=pools,
        active=np.array([1, 1, 0], np.int32))
    np.testing.assert_allclose(got[:2], want[:2], **TOL)
    _assert_pools(new, new_j)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_decode_step_paged_verify_matches(variant):
    """The speculative verify window C = K + 1 = 5: B * C rows routed
    together, lengths mid-page, one inactive row."""
    cfg = _models(variant)[0]
    rng = np.random.default_rng(5)
    ps, max_pages, batch, c = 4, 5, 3, 5
    pools, bt = _paged_inputs(cfg, rng, batch, max_pages, ps)
    toks = rng.integers(0, cfg.vocab, size=(batch, c)).astype(np.int32)
    (got, new), (want, new_j) = _paged_step(
        variant, toks, bt, np.array([6, 11, 3], np.int32), pools=pools,
        active=np.array([1, 1, 0], np.int32), spec_verify=True)
    assert got.shape[:2] == (batch, c)
    np.testing.assert_allclose(got[:2], want[:2], **TOL)
    _assert_pools(new, new_j)


@pytest.mark.parametrize("variant", ["dbrx", "kimi", "kimi_d112"])
def test_port_prefill_decode_matches_own_forward(variant):
    """The reference's own check (tests/test_serving.py) on the port, at its
    2e-1 for the MoE family; prefill's last logits equal forward's at 1e-4
    (the same T routes the same way)."""
    cfg, _, _, model, params = _models(variant)
    toks = torch.from_numpy(np.random.default_rng(6).integers(0, cfg.vocab, size=(2, 17)))
    full, _ = model.forward(params, toks)
    pre, caches = model.prefill(params, toks[:, :16], max_len=20)
    torch.testing.assert_close(pre[:, 0], model.forward(params, toks[:, :16])[0][:, -1],
                               **TOL)
    dec, _ = model.decode_step(params, caches, toks[:, 16], 16)
    torch.testing.assert_close(dec, full[:, -1], rtol=2e-1, atol=2e-1)


def test_blocks_are_moe_blocks():
    cfg, _, _, model, params = _models("dbrx")
    assert all(isinstance(blk, MoEBlock) for blk, _ in model._program(params))
    assert len(params["blocks"][0]) == cfg.n_layers
