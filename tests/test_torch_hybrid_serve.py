"""repro_torch's recurrentgemma (the hybrid family: RG-LRU blocks and
windowed local attention over a ring-buffer cache) on the dense-cache serve
path against the reference's, on bridged weights, in float32.

The reference's rg-smoke parameters go through ``from_jax_params``; the same
numpy prompts feed both packages' ``make_prefill(max_len)`` +
``make_serve_step``. Logits agree within 1e-4 (f32; the two packages sum in
different orders) and the greedy tokens are equal over 8 steps, for a prompt
of 6 (the decode crosses the window-8 ring's wrap) and of 16 and 24 (the
prefill wraps it). The caches equal the reference's leaf by leaf (ring
order, conv rows, h). The port's own prefill + decode equals its forward,
including a 2-token prompt, where the reference keeps fewer conv rows than
its decode reads (ROADMAP Queue 3) and so is no oracle.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import attention as jattn
from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.models.transformer import block_program as jax_block_program
from repro.serving.step import make_prefill as jax_make_prefill
from repro.serving.step import make_serve_step as jax_make_serve_step
from repro_torch.models import attention as tattn
from repro_torch.models import block_program, build_model, from_jax_params, get_config
from repro_torch.serving import make_prefill, make_serve_step

ARCH = "recurrentgemma-2b"
TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 8


def _pair(n_layers=None):
    cfg_j = dataclasses.replace(jax_get_config(ARCH, smoke=True), dtype="float32")
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype="float32")
    if n_layers is not None:
        cfg_j = dataclasses.replace(cfg_j, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    return cfg, model_j, params_j, model, params


@pytest.fixture(scope="module")
def pair():
    return _pair()


def _prompts(cfg, batch, length, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, length)).astype(np.int32)


def _leaves(tree, prefix=""):
    """(path, leaf) pairs of a nested cache dict, in key order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree)]


@pytest.mark.parametrize("length", [6, 16, 24])
def test_greedy_serve_matches_reference(pair, length):
    """Prefill logits, every decode step's logits, the greedy tokens, and the
    caches the loop leaves (ring order, conv rows, h)."""
    cfg, model_j, params_j, model, params = pair
    toks = _prompts(cfg, 2, length, seed=length)
    max_len = length + STEPS
    lj, cj = jax_make_prefill(model_j, max_len=max_len)(params_j, jnp.asarray(toks))
    lt, ct = make_prefill(model, max_len=max_len)(params, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    step_j, step_t = jax_make_serve_step(model_j), make_serve_step(model)
    tj = jnp.argmax(lj[:, -1, :cfg.vocab], axis=-1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1, :cfg.vocab], dim=-1).to(torch.int32)
    got, want = [tt.tolist()], [np.asarray(tj).tolist()]
    for i in range(STEPS - 1):
        lj, cj = step_j(params_j, cj, tj, jnp.int32(length + i))
        lt, ct = step_t(params, ct, tt, length + i)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
        tj = jnp.argmax(lj[:, :cfg.vocab], axis=-1).astype(jnp.int32)
        tt = torch.argmax(lt[:, :cfg.vocab], dim=-1).to(torch.int32)
        got.append(tt.tolist())
        want.append(np.asarray(tj).tolist())
    assert got == want
    assert len(ct) == len(cj) == 2  # [rg_group, rec remainder]
    for c_t, c_j in zip(ct, cj):
        lt_, lj_ = _leaves(c_t), _leaves(c_j)
        assert [p for p, _ in lt_] == [p for p, _ in lj_]
        for (path, a), (_, b) in zip(lt_, lj_):
            assert tuple(a.shape) == b.shape, path
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4, atol=2e-4,
                                       err_msg=path)


@pytest.mark.parametrize("length", [2, 16])
def test_prefill_decode_matches_forward(pair, length):
    """The port against itself: each decode step's logits equal the full
    forward's row. 16 > window 8 wraps the ring in prefill; 2 < K - 1 = 3 is
    the short-prompt conv tail (zero rows before the sequence start)."""
    cfg, _, _, model, params = pair
    G = 4
    toks = torch.from_numpy(_prompts(cfg, 2, length + G, seed=length + 1)).long()
    full, _ = model.forward(params, toks)
    _, caches = model.prefill(params, toks[:, :length], max_len=length + G)
    for g in range(G):
        logits, caches = model.decode_step(params, caches, toks[:, length + g], length + g)
        np.testing.assert_allclose(logits.numpy(), full[:, length + g].numpy(), **TOL)


@pytest.mark.parametrize("pos", [3, 7, 8, 13, 21])
def test_ring_decode_matches_reference_masked_einsum(pair, pos):
    """The windowed decode on its own: the port attends the ring at position
    min(pos, S - 1) with no window (flash_decode's plain version); the
    reference attends with its eager einsum under the absolute-position ring
    mask. Before the wrap (pos < 8), at it and after it; the ring holds
    random K/V in every slot, so a wrong live set shows."""
    cfg, model_j, params_j, model, params = pair
    pj = jax.tree.map(lambda v: v[0], params_j["blocks"][0]["attn"]["attn"])
    pt = params["blocks"][0][0]["attn"]["attn"]
    rng = np.random.default_rng(pos)
    w, hkv, dh = cfg.window, cfg.n_kv_heads, cfg.head_dim
    ring = {n: rng.standard_normal((2, hkv, w, dh)).astype(np.float32) for n in ("k", "v")}
    x = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)
    want, cj = jattn.self_attention_decode(cfg, pj, jnp.asarray(x),
                                           {n: jnp.asarray(v) for n, v in ring.items()},
                                           jnp.int32(pos), window=w)
    ct = {n: torch.from_numpy(v.copy()) for n, v in ring.items()}
    got, ct = tattn.self_attention_decode(cfg, pt, torch.from_numpy(x), ct,
                                          torch.tensor([pos], dtype=torch.int32), window=w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    for n in ("k", "v"):
        np.testing.assert_allclose(ct[n].numpy(), np.asarray(cj[n]), rtol=1e-5, atol=1e-5)


def test_init_cache_matches_reference_specs(pair):
    cfg, model_j, _, model, _ = pair
    ref = model_j.init_cache(2, 24)
    mine = model.init_cache(2, 24)
    assert len(mine) == len(ref)
    for c_t, c_j in zip(mine, ref):
        assert [(p, tuple(v.shape), str(v.dtype).split(".")[1]) for p, v in _leaves(c_t)] == \
            [(p, v.shape, v.dtype.name) for p, v in _leaves(c_j)]
        assert all(int(torch.count_nonzero(v)) == 0 for _, v in _leaves(c_t))


@pytest.mark.parametrize("n_layers", [2, 5, 26])
def test_block_program_matches_reference(n_layers):
    """26 layers: 8 groups + 2 rec; under 3 the reference keeps a zero-count
    group entry, and so does the port."""
    cfg = dataclasses.replace(get_config(ARCH), n_layers=n_layers)
    ref_cfg = dataclasses.replace(jax_get_config(ARCH), n_layers=n_layers)
    assert block_program(cfg) == [tuple(e) for e in jax_block_program(ref_cfg)]


def test_zero_group_model_matches_reference():
    """n_layers 2: the bridge splits an empty group stack and the two-rec
    remainder; prefill logits equal the reference's."""
    cfg, model_j, params_j, model, params = _pair(n_layers=2)
    assert [len(b) for b in params["blocks"]] == [0, 2]
    toks = _prompts(cfg, 2, 12, seed=5)
    lj, _ = jax_make_prefill(model_j, max_len=14)(params_j, jnp.asarray(toks))
    lt, _ = make_prefill(model, max_len=14)(params, torch.from_numpy(toks))
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)


def test_config_matches_reference():
    for smoke in (False, True):
        ref, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    full = get_config(ARCH)
    assert (full.n_layers, full.d_model, full.head_dim, full.window) == (26, 2560, 256, 2048)


def test_embedding_scale_rounds_as_the_reference():
    """x * sqrt(d_model), the f32 sqrt cast to x's dtype: in bf16 sqrt(2560)
    rounds to 50.5."""
    cfg = dataclasses.replace(get_config(ARCH, smoke=True), d_model=2560)
    model = build_model(cfg, device="cpu")
    emb = {"embedding": torch.ones((4, 2560), dtype=torch.bfloat16)}
    x = model._embed({"embed": emb}, torch.tensor([[1]]))
    want = jnp.ones((1,), jnp.bfloat16) * jnp.asarray(jnp.sqrt(2560), jnp.bfloat16)
    assert float(x[0, 0, 0]) == float(want[0]) == 50.5


def test_hybrid_has_no_paged_cache():
    """recurrentgemma keeps the reference's refusal of the paged engine."""
    model = build_model(get_config(ARCH, smoke=True), device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV caching supports dense-attention"):
        model.init_paged_cache(8, 4)
