"""repro_torch's dense model vs the JAX reference on bridged weights.

The qwen2 smoke config in float32; the reference's random parameters go
through ``from_jax_params`` and the same numpy tokens/tables feed both
packages. Logits agree within 1e-4 (f32; the two packages sum in different
orders), updated page pools within the same bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import ARCH_IDS as jax_arch_ids
from repro.models import build_model as jax_build, get_config as jax_get_config
from repro_torch.models import ModelConfig, build_model, from_jax_params, get_config
from repro_torch.models.layers import apply_rope
from repro.models.layers import apply_rope as jax_apply_rope

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    return cfg, model_j, params_j, model, params


def test_config_matches_reference():
    for smoke in (False, True):
        ref = jax_get_config("qwen2-0.5b", smoke=smoke)
        cfg = get_config("qwen2-0.5b", smoke=smoke)
        for f in dataclasses.fields(ModelConfig):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
        assert (cfg.head_dim, cfg.vocab_padded) == (ref.head_dim, ref.vocab_padded)
    full = get_config("qwen2-0.5b")
    assert (full.n_heads // full.n_kv_heads, full.head_dim) == (7, 64)


def test_bridge_keeps_layouts_and_values(models):
    cfg, _, params_j, _, params = models
    wq_j = np.asarray(params_j["blocks"][0]["attn"]["wq"])  # (L, d, h, k)
    for l in range(cfg.n_layers):
        np.testing.assert_array_equal(params["blocks"][0][l]["attn"]["wq"].numpy(), wq_j[l])
    np.testing.assert_array_equal(
        params["embed"]["embedding"].numpy(), np.asarray(params_j["embed"]["embedding"])
    )


def test_init_params_follows_the_reference_scheme(models):
    cfg, _, params_j, model, _ = models
    g = torch.Generator().manual_seed(0)
    p = model.init_params(g)
    ref_layer = jax.tree.map(lambda a: (a.shape[1:], a.dtype.name), params_j["blocks"][0])
    mine = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                        p["blocks"][0][0])
    assert mine == ref_layer
    assert len(p["blocks"][0]) == cfg.n_layers
    assert abs(float(p["embed"]["embedding"].std()) - 0.02) < 0.002
    # fan_in = shape[-2]: wq (d, h, k) draws with std 1/sqrt(h)
    wq = p["blocks"][0][0]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.n_heads ** -0.5) < 0.05
    assert torch.all(p["blocks"][0][0]["attn"]["bq"] == 0)
    assert torch.all(p["final_norm"] == 1)


@pytest.mark.parametrize("positions", ["shared", "per_row"])
def test_rope_matches_reference(positions):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 3, 5, 16)).astype(np.float32)
    pos = np.arange(5) + 7 if positions == "shared" else rng.integers(0, 4000, (2, 5))
    want = jax_apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    got = apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("batch,length", [(1, 7), (2, 12)])
def test_forward_logits_match(models, batch, length):
    cfg, model_j, params_j, model, params = models
    toks = np.random.default_rng(length).integers(0, cfg.vocab, size=(batch, length))
    want, _ = model_j.forward(params_j, jnp.asarray(toks, jnp.int32), remat=False)
    got, _ = model.forward(params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_logits_and_caches_match(models):
    cfg, model_j, params_j, model, params = models
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(1, 12))
    want, caches_j = model_j.prefill(params_j, jnp.asarray(toks, jnp.int32), max_len=16,
                                     last_index=jnp.int32(9))
    got, caches = model.prefill(params, torch.from_numpy(toks), max_len=16, last_index=9)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for name in ("k", "v"):
        ref = np.asarray(caches_j[0][name])
        assert caches[0][name].shape == ref.shape
        np.testing.assert_allclose(caches[0][name].numpy(), ref, rtol=1e-4, atol=2e-4)


def _pools(cfg, num_pages, ps, rng):
    shape = (cfg.n_layers, num_pages, cfg.n_kv_heads, ps, cfg.head_dim)
    return {n: rng.standard_normal(shape).astype(np.float32) for n in ("k", "v")}


def _tables(rng, batch, max_pages, num_pages):
    return rng.permutation(np.arange(1, num_pages)).reshape(batch, max_pages).astype(np.int32)


def test_decode_step_paged_matches(models):
    """Decode rows at different lengths (one masked inactive): logits and the
    in-place pool appends equal the reference's."""
    cfg, model_j, params_j, model, params = models
    rng = np.random.default_rng(2)
    ps, max_pages, batch = 4, 4, 3
    num_pages = batch * max_pages + 1
    pools = _pools(cfg, num_pages, ps, rng)
    bt = _tables(rng, batch, max_pages, num_pages)
    lens = np.array([5, 12, 3], np.int32)
    active = np.array([1, 1, 0], np.int32)
    toks = rng.integers(0, cfg.vocab, size=batch).astype(np.int32)
    want, new_j = model_j.decode_step_paged(
        params_j, [{n: jnp.asarray(a) for n, a in pools.items()}], jnp.asarray(toks),
        jnp.asarray(bt), jnp.asarray(lens), attn_impl="jnp", active=jnp.asarray(active),
    )
    caches = [{n: torch.from_numpy(a.copy()) for n, a in pools.items()}]
    got, new = model.decode_step_paged(
        params, caches, torch.from_numpy(toks), torch.from_numpy(bt), torch.from_numpy(lens),
        active=torch.from_numpy(active),
    )
    assert new[0]["k"] is caches[0]["k"]  # updated in place
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **TOL)
    for n in ("k", "v"):
        got_pool, want_pool = new[0][n].numpy(), np.asarray(new_j[0][n])
        np.testing.assert_allclose(got_pool[:, 1:], want_pool[:, 1:], rtol=1e-4, atol=2e-4)


def test_decode_step_paged_chunk_matches(models):
    """A prefill chunk per row: one row past a resident prefix with an adopted
    (write-protected) page, one row starting cold with a partial last page."""
    cfg, model_j, params_j, model, params = models
    rng = np.random.default_rng(3)
    ps, max_pages, batch, c = 4, 5, 2, 8
    num_pages = batch * max_pages + 1
    pools = _pools(cfg, num_pages, ps, rng)
    bt = _tables(rng, batch, max_pages, num_pages)
    wt = bt.copy()
    wt[0, :1] = 0  # row 0's first page is adopted: never written
    cursors = np.array([8, 0], np.int32)
    n_new = np.array([8, 6], np.int32)
    last = np.array([7, 5], np.int32)
    toks = rng.integers(0, cfg.vocab, size=(batch, c)).astype(np.int32)
    want, new_j = model_j.decode_step_paged(
        params_j, [{n: jnp.asarray(a) for n, a in pools.items()}], jnp.asarray(toks),
        jnp.asarray(bt), jnp.asarray(cursors), attn_impl="jnp", write_tables=jnp.asarray(wt),
        n_new=jnp.asarray(n_new), last_index=jnp.asarray(last),
    )
    caches = [{n: torch.from_numpy(a.copy()) for n, a in pools.items()}]
    t = torch.from_numpy
    got, new = model.decode_step_paged(
        params, caches, t(toks), t(bt), t(cursors), write_tables=t(wt),
        n_new=t(n_new), last_index=t(last),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(new[0][n].numpy()[:, 1:], np.asarray(new_j[0][n])[:, 1:],
                                   rtol=1e-4, atol=2e-4)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-90b"])
def test_unported_architectures_raise(arch):
    """The cross-attention families resolve and serve on the dense cache,
    but their paged path is not ported, as in the reference (whose
    paged_cache_specs refuses the dec and vis_group kinds): init_paged_cache,
    decode_step_paged and ServeEngine raise NotImplementedError."""
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    kind = {"encdec": "dec", "vlm": "vis_group"}[cfg.family]
    match = f"paged KV caching supports dense-attention blocks; got '{kind}'"
    with pytest.raises(NotImplementedError, match=match):
        model.init_paged_cache(8, 4)
    with pytest.raises(NotImplementedError, match=match):
        model.decode_step_paged(params, [], torch.zeros(1, dtype=torch.int32),
                                torch.zeros((1, 2), dtype=torch.int32),
                                torch.zeros(1, dtype=torch.int32))
    with pytest.raises(NotImplementedError, match=match):
        ServeEngine(model, params, EngineConfig(num_pages=8, page_size=4), device="cpu")
    with pytest.raises(NotImplementedError):
        jax_build(dataclasses.replace(jax_get_config(arch, smoke=True))).paged_cache_specs(8, 4)


def _reference_shapes(arch):
    """The reference's parameter spec tree at full size as {path: (shape,
    dtype)} (specs only: nothing is allocated)."""
    from repro.core.distributed import is_spec

    specs = jax_build(jax_get_config(arch)).param_specs()
    flat = jax.tree_util.tree_flatten_with_path(specs, is_leaf=is_spec)[0]
    return {jax.tree_util.keystr(p): (s.shape, jnp.dtype(s.dtype).name) for p, s in flat}


def _port_shapes(model):
    """The port's spec tree as the reference's stacked tree: each program
    entry's per-layer specs with a leading layer dim, a vision group's list of
    self layers as a second one, whisper's encoder likewise."""
    from repro_torch.models.layers import ParamSpec

    out = {}

    def walk(tree, path, lead):
        if isinstance(tree, ParamSpec):
            out[path] = (lead + tree.shape, str(tree.dtype).split(".")[1])
        elif isinstance(tree, dict):
            for k, v in tree.items():
                if isinstance(v, list):  # a vision group's self layers
                    walk(v[0], f"{path}['{k}']", lead + (len(v),))
                else:
                    walk(v, f"{path}['{k}']", lead)

    specs = model.param_specs()
    for name in ("embed", "final_norm"):
        walk(specs[name], f"['{name}']", ())
    for i, layers in enumerate(specs["blocks"]):
        walk(layers[0], f"['blocks'][{i}]", (len(layers),))
    if "encoder" in specs:
        walk(specs["encoder"]["blocks"][0][0], "['encoder']['blocks'][0]",
             (len(specs["encoder"]["blocks"][0]),))
        walk(specs["encoder"]["final_norm"], "['encoder']['final_norm']", ())
    return out


@pytest.mark.parametrize("arch", jax_arch_ids)
def test_param_specs_and_count_match_reference(arch):
    """At full size, for every architecture id: the port's parameter specs
    leaf by leaf (shape and dtype, as the reference stacks them) and
    count_params, total and active, equal the reference's."""
    from repro.models.registry import count_params as jax_count_params
    from repro_torch.models import ARCH_IDS, count_params

    assert ARCH_IDS == jax_arch_ids
    cfg = get_config(arch)
    assert _port_shapes(build_model(cfg, device="cpu")) == _reference_shapes(arch)
    for active in (False, True):
        assert count_params(cfg, active_only=active) == \
            jax_count_params(jax_get_config(arch), active_only=active), active


def test_unknown_architecture_raises():
    with pytest.raises(KeyError):
        get_config("no-such-model")
