"""repro_torch's quantized serving path vs the JAX reference on bridged weights.

The qwen2 smoke config in float32, built with ``quantized=True`` in both
packages (int8 MLP weights with per-(row, block) scales, bridged byte for
byte), and served over int8 and int4 KV pages. Model-level logits agree
within 1e-5 (f32; the packages sum in different orders); engine greedy
tokens are identical on the reference's own engine scenarios, CoW of a
quantized page, preemption and chunked prefill with shared-prefix skip
included.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import build_model as jax_build, get_config as jax_get_config
from repro.serving import GenerationParams as JaxGenerationParams
from repro.serving.engine import (
    EngineConfig as JaxEngineConfig,
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from repro.serving.engine.kvquant import KV_DTYPES as JAX_KV_DTYPES
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams
from repro_torch.serving.engine import KV_DTYPES, EngineConfig, Request, ServeEngine
from repro_torch.serving.engine.kvquant import kv_pool_bytes

TOL = dict(rtol=1e-5, atol=1e-5)
KV = ["int8", "int4"]


def _scenarios(vocab):
    """name -> (requests [(prompt, max_new_tokens)], EngineConfig kwargs): the
    reference engine tests' mixed lengths, forced CoW of a shared partial
    page, preemption under page pressure, and chunked prefill with
    shared-prefix compute skip."""
    out = {}
    rng = np.random.default_rng(0)
    out["mixed_lengths"] = (
        [(rng.integers(0, vocab, size=L).tolist(), 6) for L in (5, 9, 16, 3, 12)],
        dict(num_pages=32, page_size=4, max_batch=4, max_pages_per_seq=8),
    )
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, vocab, size=10).tolist()
    out["forced_cow"] = (
        [(list(prompt), 6) for _ in range(3)],
        dict(num_pages=32, page_size=4, max_batch=3, max_pages_per_seq=8),
    )
    rng = np.random.default_rng(1)
    out["preemption"] = (
        [(rng.integers(0, vocab, size=8).tolist(), 10) for _ in range(3)],
        dict(num_pages=10, page_size=4, max_batch=3, max_pages_per_seq=6),
    )
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, vocab, size=16).tolist()
    out["chunked_skip"] = (
        [(prefix + rng.integers(0, vocab, size=4).tolist(), 11),
         (rng.integers(0, vocab, size=5).tolist(), 2),
         (prefix + rng.integers(0, vocab, size=3).tolist(), 5),
         (list(prefix), 5)],
        dict(num_pages=48, page_size=4, max_batch=2, max_pages_per_seq=9,
             chunked_prefill=True, chunk_tokens=8),
    )
    return out


SCENARIOS = list(_scenarios(512))


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j, quantized=True)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, quantized=True, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    return cfg, model_j, params_j, model, params


@pytest.fixture(scope="module")
def reference(setup):
    """The reference engine's greedy tokens and metrics per (scenario, kv)."""
    cfg, model_j, params_j, _, _ = setup
    out = {}
    for name, (spec, kw) in _scenarios(cfg.vocab).items():
        for kv in KV:
            eng = JaxServeEngine(model_j, params_j, JaxEngineConfig(**kw, kv_dtype=kv))
            res = eng.run([
                JaxRequest(rid=i, prompt=list(p), params=JaxGenerationParams(max_new_tokens=n))
                for i, (p, n) in enumerate(spec)
            ])
            out[name, kv] = ({i: list(res[i].generated) for i in res}, eng.metrics())
    return out


def test_quantized_specs_and_bridge_match_reference(setup):
    cfg, _, params_j, model, params = setup
    ref_mlp = params_j["blocks"][0]["mlp"]
    mine = model.init_params(torch.Generator().manual_seed(0))["blocks"][0][0]["mlp"]
    for name in ("w_gate", "w_up", "w_down"):
        for part in ("q", "scale"):
            want = np.asarray(ref_mlp[name][part])
            assert tuple(mine[name][part].shape) == want.shape[1:], (name, part)
            assert str(mine[name][part].dtype).split(".")[1] == want.dtype.name
            for layer in range(cfg.n_layers):
                got = params["blocks"][0][layer]["mlp"][name][part]
                np.testing.assert_array_equal(got.numpy(), want[layer])
    assert params["blocks"][0][0]["mlp"]["w_up"]["q"].dtype == torch.int8


@pytest.mark.parametrize("batch,length", [(1, 7), (2, 12)])
def test_quantized_forward_logits_match(setup, batch, length):
    cfg, model_j, params_j, model, params = setup
    toks = np.random.default_rng(length).integers(0, cfg.vocab, size=(batch, length))
    want, _ = model_j.forward(params_j, jnp.asarray(toks, jnp.int32), remat=False)
    got, _ = model.forward(params, torch.from_numpy(toks))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _quant_pools(cfg, kv, num_pages, ps, rng):
    """Random quantized pools (the same bytes for both packages)."""
    dq = KV_DTYPES[kv].packed_dim(cfg.head_dim)
    leaf = lambda: {
        "q": rng.integers(-100, 100, size=(cfg.n_layers, num_pages, cfg.n_kv_heads, ps, dq)
                          ).astype(np.int8),
        "scale": (np.abs(rng.standard_normal((cfg.n_layers, num_pages, cfg.n_kv_heads)))
                  * 0.05 + 0.01).astype(np.float32),
    }
    return {"k": leaf(), "v": leaf()}


def _as(pools, fn):
    return [{n: {p: fn(a) for p, a in leaf.items()} for n, leaf in pools.items()}]


def _check_pools(new, new_j, kv):
    """Pools after the step: what both packages wrote (pages 1..) agrees to
    within one quantization step, and the scales within 1e-5 relative: the
    K/V values they quantize differ in the last f32 bits (different sum
    orders), so a value on a rounding boundary may land one step apart."""
    spec = KV_DTYPES[kv]
    for n in ("k", "v"):
        got = spec.decode_pages(new[0][n]["q"], new[0][n]["scale"]).numpy()[:, 1:]
        want = np.asarray(JAX_KV_DTYPES[kv].decode_pages(new_j[0][n]["q"],
                                                         new_j[0][n]["scale"]))[:, 1:]
        step = new[0][n]["scale"].numpy()[:, 1:, :, None, None]
        assert np.all(np.abs(got - want) <= step * 1.001 + 1e-6)
        np.testing.assert_allclose(new[0][n]["scale"].numpy()[:, 1:],
                                   np.asarray(new_j[0][n]["scale"])[:, 1:], rtol=1e-5, atol=0)


@pytest.mark.parametrize("kv", KV)
def test_decode_step_paged_quant_matches(setup, kv):
    """Decode rows at different lengths (one at slot 0 of a fresh page, one
    mid-page, one masked inactive) over a quantized pool."""
    cfg, model_j, params_j, model, params = setup
    rng = np.random.default_rng(2)
    ps, max_pages, batch = 4, 4, 3
    num_pages = batch * max_pages + 1
    pools = _quant_pools(cfg, kv, num_pages, ps, rng)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(batch, max_pages).astype(np.int32)
    lens = np.array([4, 11, 3], np.int32)
    active = np.array([1, 1, 0], np.int32)
    toks = rng.integers(0, cfg.vocab, size=batch).astype(np.int32)
    want, new_j = model_j.decode_step_paged(
        params_j, _as(pools, jnp.asarray), jnp.asarray(toks), jnp.asarray(bt),
        jnp.asarray(lens), attn_impl="jnp", kv_spec=JAX_KV_DTYPES[kv],
        active=jnp.asarray(active),
    )
    caches = _as(pools, lambda a: torch.from_numpy(a.copy()))
    got, new = model.decode_step_paged(
        params, caches, torch.from_numpy(toks), torch.from_numpy(bt), torch.from_numpy(lens),
        kv_spec=KV_DTYPES[kv], active=torch.from_numpy(active),
    )
    assert new[0]["k"]["q"] is caches[0]["k"]["q"]  # updated in place
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **TOL)
    _check_pools(new, new_j, kv)


@pytest.mark.parametrize("kv", KV)
def test_chunk_step_paged_quant_matches(setup, kv):
    """A prefill chunk per row over a quantized pool: one row past a resident
    prefix with an adopted (write-protected) page, one starting cold with a
    partial last page."""
    cfg, model_j, params_j, model, params = setup
    rng = np.random.default_rng(3)
    ps, max_pages, batch, c = 4, 5, 2, 8
    num_pages = batch * max_pages + 1
    pools = _quant_pools(cfg, kv, num_pages, ps, rng)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(batch, max_pages).astype(np.int32)
    wt = bt.copy()
    wt[0, :1] = 0
    cursors, n_new, last = (np.array(a, np.int32) for a in ([8, 0], [8, 6], [7, 5]))
    toks = rng.integers(0, cfg.vocab, size=(batch, c)).astype(np.int32)
    want, new_j = model_j.decode_step_paged(
        params_j, _as(pools, jnp.asarray), jnp.asarray(toks), jnp.asarray(bt),
        jnp.asarray(cursors), attn_impl="jnp", kv_spec=JAX_KV_DTYPES[kv],
        write_tables=jnp.asarray(wt), n_new=jnp.asarray(n_new), last_index=jnp.asarray(last),
    )
    t = torch.from_numpy
    got, new = model.decode_step_paged(
        params, _as(pools, lambda a: t(a.copy())), t(toks), t(bt), t(cursors),
        kv_spec=KV_DTYPES[kv], write_tables=t(wt), n_new=t(n_new), last_index=t(last),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _check_pools(new, new_j, kv)


@pytest.mark.parametrize("kv", KV)
@pytest.mark.parametrize("name", SCENARIOS)
def test_quantized_engine_greedy_tokens_identical_to_reference(setup, reference, name, kv):
    cfg, _, _, model, params = setup
    spec, kw = _scenarios(cfg.vocab)[name]
    eng = ServeEngine(model, params, EngineConfig(**kw, kv_dtype=kv), device="cpu")
    res = eng.run([Request(rid=i, prompt=list(p), params=GenerationParams(max_new_tokens=n))
                   for i, (p, n) in enumerate(spec)])
    want, ref_m = reference[name, kv]
    assert {i: res[i].generated for i in res} == want
    m = eng.metrics()
    for key in ("pages_shared", "cow_copies", "preemptions", "prefill_tokens_skipped",
                "kv_pool_bytes", "peak_pages_in_use"):
        assert m[key] == ref_m[key], key
    assert eng.cache.num_free == eng.cache.num_pages - 1 and int(eng.cache.ref.sum()) == 0
    if name == "forced_cow":
        assert m["cow_copies"] >= 2
    if name == "preemption":
        assert m["preemptions"] >= 1


def test_quantized_pool_bytes_and_dense_view(setup):
    """Same pages, a fraction of the bytes (the reference's >= 1.9x law for
    int8 against f32 pages), and the int8 pool read back through the spec
    equals the prefill K/V within half a quantization step."""
    cfg, _, _, model, params = setup
    kw = dict(num_pages=16, page_size=4, max_batch=2, max_pages_per_seq=8)
    nbytes = {kv: kv_pool_bytes(ServeEngine(model, params, EngineConfig(**kw, kv_dtype=kv),
                                            device="cpu").cache.pools)
              for kv in ("f32", "int8", "int4")}
    assert nbytes["f32"] / nbytes["int8"] >= 1.9 and nbytes["int8"] > nbytes["int4"]
    prompt = np.random.default_rng(7).integers(0, cfg.vocab, size=10).tolist()
    eng = ServeEngine(model, params, EngineConfig(**kw, kv_dtype="int8"), device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, params=GenerationParams(max_new_tokens=1)))
    eng.queue.push(eng._pending.pop())
    eng._admit_and_prefill(0.0)
    k_paged, v_paged = eng.cache.dense_view(0)
    _, caches = model.prefill(params, torch.tensor([prompt]), max_len=12)
    for got, want, name in ((k_paged, caches[0]["k"], "k"), (v_paged, caches[0]["v"], "v")):
        scale = eng.cache.pools[0][name]["scale"][0][eng.cache.pages_of[0][:3]]  # (3, Hkv)
        step = scale.transpose(0, 1).repeat_interleave(4, dim=1)[:, :10, None]
        assert torch.all((got - want[0, 0, :, :10]).abs() <= step / 2 + 1e-7)


def test_kv_dtype_outside_kv_dtypes_raises(setup):
    """As the reference: a kv_dtype name outside KV_DTYPES is a ValueError."""
    cfg, model_j, params_j, model, params = setup
    with pytest.raises(ValueError, match="kv_dtype"):
        JaxServeEngine(model_j, params_j, JaxEngineConfig(num_pages=8, kv_dtype="fp8"))
    with pytest.raises(ValueError, match="kv_dtype"):
        ServeEngine(model, params, EngineConfig(num_pages=8, kv_dtype="fp8"), device="cpu")
