"""repro_torch's speculative verify attention vs the JAX reference.

``models.attention.self_attention_verify_paged`` (C = K + 1 tokens a row
appended one by one at any alignment, the present gathered back from the
pool, one chunk-attention call) is held against the reference's function on
the same numpy inputs and bridged qwen2-0.5b smoke weights (f32
activations) over f32, bf16, int8 and int4 pools, with resident lengths
mid-page and on a page boundary, and so is ``Model.decode_step_paged(...,
spec_verify=True)`` with an inactive row. The plain chunk attention at the
verify's shapes (C 2 and 5, cursors off page boundaries) is held against
the reference's ``ops.paged_prefill_chunk_attention(_quant)`` in Pallas
interpret mode. Outputs within 1e-4 (f32; the packages sum in different
orders), 2e-5 for the attention alone; pools equal.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.models import attention as jattn
from repro.models import build_model as jax_build, get_config as jax_get_config
from repro.serving.engine.kvquant import KV_DTYPES as JAX_KV_DTYPES
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving.engine import KV_DTYPES

TOL = dict(rtol=1e-4, atol=1e-4)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
PS = 4
LENS = {"mid_page": [5, 13, 2], "aligned": [4, 8, 0]}


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    return cfg, model_j, params_j, model, params


def _pool(cfg, pool, num_pages, rng, layers=None):
    """Random pools in the ``pool`` representation, as numpy arrays: one
    layer's ({"k", "v"}: (num_pages, Hkv, ps, Dh)) or ``layers`` stacked."""
    lead = () if layers is None else (layers,)
    shape = lead + (num_pages, cfg.n_kv_heads, PS, cfg.head_dim)
    out = {}
    for name in ("k", "v"):
        x = rng.standard_normal(shape).astype(np.float32)
        if pool in ("int8", "int4"):
            enc = JAX_KV_DTYPES[pool].encode_pages(jnp.asarray(x))
            out[name] = {"q": np.asarray(enc["q"]), "scale": np.asarray(enc["scale"])}
        elif pool == "bf16":
            out[name] = np.asarray(jnp.asarray(x, jnp.bfloat16))
        else:
            out[name] = x
    return out


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def _to_torch(tree):
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    if tree.dtype == jnp.bfloat16:
        return torch.from_numpy(tree.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(tree.copy())


def _as_np(t):
    if isinstance(t, dict):
        return {k: _as_np(v) for k, v in t.items()}
    if isinstance(t, torch.Tensor):
        return t.float().numpy() if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(t.astype(jnp.float32) if t.dtype == jnp.bfloat16 else t)


def _assert_pools_equal(got, want):
    for name in ("k", "v"):
        g, w = _as_np(got[name]), _as_np(want[name])
        if isinstance(w, dict):
            np.testing.assert_array_equal(g["q"], w["q"])
            np.testing.assert_allclose(g["scale"], w["scale"], rtol=1e-6, atol=0)
        else:
            np.testing.assert_allclose(g, w, rtol=1e-5, atol=1e-5)


def _tables(rng, batch, max_pages, num_pages):
    return rng.permutation(np.arange(1, num_pages))[:batch * max_pages].reshape(
        batch, max_pages).astype(np.int32)


@pytest.mark.parametrize("lens_case", sorted(LENS))
@pytest.mark.parametrize("c", [2, 5])
@pytest.mark.parametrize("pool", ["f32", "bf16", "int8", "int4"])
def test_self_attention_verify_paged_equals_reference(models, pool, c, lens_case):
    cfg, model_j, params_j, model, params = models
    rng = np.random.default_rng(len(pool) * 10 + c)
    lens = np.array(LENS[lens_case], np.int32)
    b, max_pages = len(lens), 6
    num_pages = b * max_pages + 1
    pools = _pool(cfg, pool, num_pages, rng)
    bt = _tables(rng, b, max_pages, num_pages)
    x = rng.standard_normal((b, c, cfg.d_model)).astype(np.float32)
    p_j = jax.tree.map(lambda a: a[0], params_j["blocks"][0]["attn"])
    spec_j = JAX_KV_DTYPES.get(pool) if pool.startswith("int") else None
    want, new_j = jattn.self_attention_verify_paged(
        cfg, p_j, jnp.asarray(x), _to_jax(pools), jnp.asarray(bt), jnp.asarray(lens),
        impl="jnp", kv_spec=spec_j,
    )
    cache = _to_torch(pools)
    spec = KV_DTYPES.get(pool) if pool.startswith("int") else None
    got, new = tattn.self_attention_verify_paged(
        cfg, params["blocks"][0][0]["attn"], torch.from_numpy(x), cache, torch.from_numpy(bt),
        torch.from_numpy(lens), kv_spec=spec,
    )
    assert new is cache  # appended in place
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    _assert_pools_equal(new, new_j)


@pytest.mark.parametrize("pool", ["f32", "int8"])
def test_decode_step_paged_spec_verify_equals_reference(models, pool):
    """The whole verify step: logits of all C rows, pools, an inactive row
    (its table and length nulled, its writes in the null page)."""
    cfg, model_j, params_j, model, params = models
    rng = np.random.default_rng(5)
    lens = np.array([6, 12, 3], np.int32)
    active = np.array([1, 1, 0], np.int32)
    b, max_pages, c = len(lens), 5, 4
    num_pages = b * max_pages + 1
    pools = _pool(cfg, pool, num_pages, rng, layers=cfg.n_layers)
    bt = _tables(rng, b, max_pages, num_pages)
    toks = rng.integers(0, cfg.vocab, size=(b, c)).astype(np.int32)
    spec_j = JAX_KV_DTYPES.get(pool)
    want, new_j = model_j.decode_step_paged(
        params_j, [_to_jax(pools)], jnp.asarray(toks), jnp.asarray(bt), jnp.asarray(lens),
        attn_impl="jnp", kv_spec=spec_j, active=jnp.asarray(active), spec_verify=True,
    )
    caches = [_to_torch(pools)]
    got, new = model.decode_step_paged(
        params, caches, torch.from_numpy(toks), torch.from_numpy(bt), torch.from_numpy(lens),
        kv_spec=KV_DTYPES.get(pool), active=torch.from_numpy(active), spec_verify=True,
    )
    assert got.shape == np.asarray(want).shape and got.shape[:2] == (b, c)
    np.testing.assert_allclose(got.numpy()[:2], np.asarray(want)[:2], **TOL)
    drop_null = lambda tree: jax.tree.map(lambda a: np.asarray(a)[:, 1:], _as_np(tree))
    _assert_pools_equal(drop_null(new[0]), drop_null(new_j[0]))


# ---------------------------------------------------------------------------------
# the plain chunk attention at the verify's shapes vs the Pallas kernel
# ---------------------------------------------------------------------------------
HQ, HKV, D, CPS, MAXP = 14, 2, 64, 16, 4
CURSORS = {"mid_page": [3, 17, 37], "aligned": [16, 0, 48]}


def _chunk_inputs(c, cursors, seed):
    rng = np.random.default_rng(seed)
    b = len(cursors)
    num = b * MAXP + 1
    q = rng.standard_normal((b, HQ, c, D)).astype(np.float32)
    ck, cv = (rng.standard_normal((b, HKV, c, D)).astype(np.float32) for _ in range(2))
    kp, vp = (rng.standard_normal((num, HKV, CPS, D)).astype(np.float32) for _ in range(2))
    bt = _tables(rng, b, MAXP, num)
    return q, ck, cv, kp, vp, bt, np.array(cursors, np.int32)


@pytest.mark.parametrize("cursor_case", sorted(CURSORS))
@pytest.mark.parametrize("c", [2, 5])
def test_plain_chunk_at_verify_shapes_equals_pallas(c, cursor_case):
    arrays = _chunk_inputs(c, CURSORS[cursor_case], seed=c)
    want = jops.paged_prefill_chunk_attention(*[jnp.asarray(a) for a in arrays], impl="pallas")
    got = ops.paged_prefill_chunk_attention(*[torch.from_numpy(a) for a in arrays])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)


@pytest.mark.parametrize("cursor_case", sorted(CURSORS))
@pytest.mark.parametrize("c", [2, 5])
@pytest.mark.parametrize("bits", [8, 4])
def test_plain_chunk_quant_at_verify_shapes_equals_pallas(bits, c, cursor_case):
    q, ck, cv, kp, vp, bt, cur = _chunk_inputs(c, CURSORS[cursor_case], seed=10 + c)
    enc = JAX_KV_DTYPES[f"int{bits}"]
    k, v = enc.encode_pages(jnp.asarray(kp)), enc.encode_pages(jnp.asarray(vp))
    arrays = (q, ck, cv, np.array(k["q"]), np.array(k["scale"]), np.array(v["q"]),
              np.array(v["scale"]), bt, cur)
    want = jops.paged_prefill_chunk_attention_quant(*[jnp.asarray(a) for a in arrays],
                                                    bits=bits, impl="pallas")
    got = ops.paged_prefill_chunk_attention_quant(*[torch.from_numpy(a) for a in arrays],
                                                  bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN_TOL)
