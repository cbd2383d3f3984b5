"""repro_torch's dense-cache serve path (make_prefill(max_len) then
make_serve_step in a greedy loop) against the reference's, on bridged
weights, for the qwen2 and mamba2 smoke configs in float32.

The reference's random parameters go through ``from_jax_params``; the same
numpy prompts feed both packages. Logits agree within 1e-4 (f32; the two
packages sum in different orders) and the greedy tokens are equal over 8
steps. The port's own prefill + decode also equals its full forward (the
analogue of the reference's test_prefill_decode_matches_forward and
test_scan_archs_exact_in_f32), and the cache layouts equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.serving.step import make_prefill as jax_make_prefill
from repro.serving.step import make_serve_step as jax_make_serve_step
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import make_prefill, make_serve_step

ARCHS = ["qwen2-0.5b", "mamba2-780m"]
TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 8


def _pair(arch):
    cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    return cfg, model_j, params_j, model, params


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    return _pair(request.param)


def _prompts(cfg, batch, length, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, length)).astype(np.int32)


@pytest.mark.parametrize("length", [13, 16])
def test_greedy_serve_matches_reference(pair, length):
    """A ragged and a chunk-multiple prompt (the SSD prefill's two chunkings):
    prefill logits, every decode step's logits, and the greedy tokens."""
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
    for c_t, c_j in zip(ct, cj):  # the caches the loop leaves, leaf by leaf
        assert sorted(c_t) == sorted(c_j)
        for name in c_t:
            assert tuple(c_t[name].shape) == c_j[name].shape
            np.testing.assert_allclose(c_t[name].numpy(), np.asarray(c_j[name]), rtol=1e-4,
                                       atol=2e-4)


def test_prefill_decode_matches_forward(pair):
    """The port against itself: the last decode step's logits equal the full
    forward's last row, and a 4-token greedy continuation equals forward over
    the same sequence."""
    cfg, _, _, model, params = pair
    toks = torch.from_numpy(_prompts(cfg, 2, 20, seed=1)).long()
    S, G = 16, 4
    full, _ = model.forward(params, toks)
    _, caches = model.prefill(params, toks[:, :S], max_len=S + G)
    for g in range(G):
        logits, caches = model.decode_step(params, caches, toks[:, S + g], S + g)
        np.testing.assert_allclose(logits.numpy(), full[:, S + g].numpy(), **TOL)


def test_decode_position_as_a_tensor(pair):
    """``pos`` as a one-element int32 tensor (the device scalar the kernels
    read) gives the same step as the int."""
    cfg, _, _, model, params = pair
    toks = torch.from_numpy(_prompts(cfg, 2, 10, seed=2))
    outs = []
    for pos in (10, torch.tensor([10], dtype=torch.int32)):
        _, caches = model.prefill(params, toks, max_len=12)
        logits, caches = model.decode_step(params, caches, toks[:, 0], pos)
        outs.append(logits)
    torch.testing.assert_close(outs[0], outs[1], rtol=0, atol=0)


def test_init_cache_matches_reference_specs(pair):
    cfg, model_j, _, model, _ = pair
    ref = model_j.init_cache(2, 24)
    mine = model.init_cache(2, 24)
    assert len(mine) == len(ref)
    for c_t, c_j in zip(mine, ref):
        assert {k: (tuple(v.shape), str(v.dtype).split(".")[1]) for k, v in c_t.items()} == \
            {k: (v.shape, v.dtype.name) for k, v in c_j.items()}
        assert all(int(torch.count_nonzero(v)) == 0 for v in c_t.values())


def test_mamba2_config_matches_reference():
    for smoke in (False, True):
        ref, cfg = jax_get_config("mamba2-780m", smoke=smoke), get_config("mamba2-780m",
                                                                          smoke=smoke)
        for f in dataclasses.fields(cfg):
            assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
        assert (cfg.ssm_dinner, cfg.ssm_nheads, cfg.ssm_conv_dim, cfg.vocab_padded) == \
            (ref.ssm_dinner, ref.ssm_nheads, ref.ssm_conv_dim, ref.vocab_padded)
    full = get_config("mamba2-780m")
    assert (full.ssm_nheads, full.ssm_headdim, full.ssm_state) == (48, 64, 128)


def test_mamba2_has_no_paged_cache():
    """The SSM family keeps the reference's refusal of the paged engine."""
    cfg = get_config("mamba2-780m", smoke=True)
    model = build_model(cfg, device="cpu")
    with pytest.raises(NotImplementedError, match="paged KV caching supports dense-attention"):
        model.init_paged_cache(8, 4)


def test_windowed_decode_waits_for_its_slice():
    """A local attention window is ported with the recurrentgemma slice: a
    dense-family config that sets one builds, and, as the reference's "dense"
    block kind, ignores it (only the hybrid family's local_attn kind uses
    the window): its prefill and decode equal the same config's without."""
    base = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    toks = torch.from_numpy(_prompts(base, 2, 10, seed=3))
    outs = []
    for cfg in (base, dataclasses.replace(base, window=3)):
        model = build_model(cfg, device="cpu")
        params = model.init_params(torch.Generator().manual_seed(0))
        first, caches = model.prefill(params, toks, max_len=12)
        logits, _ = model.decode_step(params, caches, toks[:, 0], 10)
        outs.append((first, logits))
    for a, b in zip(*outs):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decode_past_the_dense_cache_capacity_is_refused():
    """A dense cache without a window holds max_len tokens: decoding at an
    int position at or past it raises a ValueError naming the capacity (the
    reference would write slot pos % S and silently drop the oldest token)."""
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_prompts(cfg, 2, 10, seed=3))
    _, caches = model.prefill(params, toks, max_len=12)
    for pos in (10, 11):
        logits, caches = model.decode_step(params, caches, toks[:, 0], pos)
        assert torch.isfinite(logits).all()
    with pytest.raises(ValueError, match="capacity of 12"):
        model.decode_step(params, caches, toks[:, 0], 12)


@pytest.mark.parametrize("form", ["int", "DecodePos"])
def test_the_attention_layer_checks_its_own_capacity(form):
    """The capacity check lives in self_attention_decode, so a direct caller
    gets it too: a host position (an int, or a DecodePos carrying one beside
    its device tensor) at or past the dense cache's S raises; a window's ring
    wraps instead; a device tensor alone is not read on the host."""
    from repro_torch.models import attention as attn

    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_prompts(cfg, 2, 10, seed=4))
    _, caches = model.prefill(params, toks, max_len=12)
    p = params["blocks"][0][0]["attn"]
    cache = {k: v[0].clone() for k, v in caches[0].items()}
    x = torch.from_numpy(np.random.default_rng(5).standard_normal(
        (2, 1, cfg.d_model)).astype(np.float32))
    pos = (lambda n: n) if form == "int" else (
        lambda n: attn.DecodePos(n, torch.tensor([n], dtype=torch.int32)))
    y, _ = attn.self_attention_decode(cfg, p, x, cache, pos(11))
    assert torch.isfinite(y).all()
    with pytest.raises(ValueError, match="capacity of 12"):
        attn.self_attention_decode(cfg, p, x, cache, pos(12))
    y, _ = attn.self_attention_decode(cfg, p, x, cache, pos(12), window=12)
    assert torch.isfinite(y).all()
    y, _ = attn.self_attention_decode(cfg, p, x, cache, torch.tensor([11], dtype=torch.int32))
    assert torch.isfinite(y).all()
