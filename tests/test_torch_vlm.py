"""llama-3.2-vision-90b (the vlm family) in repro_torch against the JAX
package, on the vision-smoke config (one group of 4 dense self-attention
layers and a gated cross-attention layer, d_model 64, 4 / 2 heads of 16,
8 image tokens) and on it at 10 layers (two groups, so the doubly stacked
(G, 4, ...) self leaves and caches have G > 1).

The weights are the port's seeded init as the reference's tree
(``bridged_pair``) with every group's gate at 0.7: the reference's init
sets it to 0, where tanh(0) erases the cross layer and a wrong
cross-attention would pass. Image embeddings and prompts are numpy draws
from a seed, fed in the param dtype to both. What must agree, in f32
within 1e-4: ``encode_ctx`` (the embeddings as given);
``make_prefill(max_len)(..., batch_inputs=)`` then ``make_serve_step``
logits a step, 8 greedy tokens equal, the caches leaf by leaf ({"self":
(G, 4, B, Hkv, S, Dh), "cross"}). The port's prefill + decode equals its own
``forward(ctx=)``; at gate 0 its logits do not depend on the image, at 0.7
they do. In bf16 the port's drift from the reference's f32 logits stays
within 2x the reference's own bf16 drift.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import get_config as jax_get_config
from repro_torch.models import ModelConfig, block_program, get_config
from test_torch_cross_attention import (
    VISION_GATE, assert_caches_equal, bf16_drifts, bridged_pair, context_inputs, serve_pair,
)

ARCH = "llama-3.2-vision-90b"
TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 8
_PAIRS = {}


def _pair(n_layers=5, **kw):
    key = (n_layers,) + tuple(sorted(kw.items()))
    if key not in _PAIRS:
        _PAIRS[key] = bridged_pair(ARCH, n_layers=n_layers, **kw)
    return _PAIRS[key]


def _prompts(cfg, batch, length, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, length)).astype(
        np.int32)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    ref, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert block_program(cfg) == [("vis_group", cfg.n_layers // 5)]
    if not smoke:
        assert (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim, cfg.d_ff,
                cfg.n_img_tokens, cfg.vocab) == (100, 8192, 64, 8, 128, 28672, 6404, 128256)


def test_bridge_splits_the_groups():
    """(G, 4, ...) self leaves -> G groups of 4 layer dicts; the (G,) gate ->
    a 0-d f32 tensor a group."""
    cfg, _, params_j, _, params = _pair(10)
    groups = params["blocks"][0]
    assert len(groups) == 2 and all(len(g["self"]) == 4 for g in groups)
    wq = np.asarray(params_j["blocks"][0]["self"]["attn"]["wq"])  # (G, 4, D, H, Dh)
    for g, grp in enumerate(groups):
        assert grp["gate"].shape == () and grp["gate"].dtype == torch.float32
        assert float(grp["gate"]) == pytest.approx(VISION_GATE)
        for i in range(4):
            np.testing.assert_array_equal(grp["self"][i]["attn"]["wq"].numpy(), wq[g, i])
        np.testing.assert_array_equal(grp["cross"]["wk"].numpy(),
                                      np.asarray(params_j["blocks"][0]["cross"]["wk"])[g])


def test_encode_ctx_is_the_image_embeddings():
    cfg, model_j, params_j, model, params = _pair()
    emb = context_inputs(cfg, 2, seed=1)["image_embeds"]
    want = model_j.encode_ctx(params_j, {"image_embeds": jnp.asarray(emb)})
    got = model.encode_ctx(params, {"image_embeds": torch.from_numpy(emb)})
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("n_layers,length", [(5, 7), (10, 16)])
def test_greedy_serve_matches_reference(n_layers, length):
    pair = _pair(n_layers)
    cfg = pair[0]
    got, want, toks_t, toks_j, ct, cj = serve_pair(
        pair, _prompts(cfg, 2, length, length), context_inputs(cfg, 2, seed=length), STEPS)
    np.testing.assert_allclose(got, want, **TOL)
    assert toks_t == toks_j and len(toks_t) == STEPS
    assert_caches_equal(ct, cj, rtol=1e-4, atol=2e-4)
    g = n_layers // 5
    assert ct[0]["self"]["k"].shape == (g, 4, 2, cfg.n_kv_heads, length + STEPS, cfg.head_dim)
    assert ct[0]["cross"]["k"].shape == (g, 2, cfg.n_kv_heads, cfg.n_img_tokens, cfg.head_dim)


def test_prefill_decode_matches_forward():
    cfg, _, _, model, params = _pair(10)
    toks = torch.from_numpy(_prompts(cfg, 2, 20, 5)).long()
    inputs = {k: torch.from_numpy(a) for k, a in context_inputs(cfg, 2, seed=5).items()}
    S, G = 16, 4
    full, _ = model.forward(params, toks, ctx=model.encode_ctx(params, inputs))
    _, caches = model.prefill(params, toks[:, :S], batch_inputs=inputs, max_len=S + G)
    for g in range(G):
        logits, caches = model.decode_step(params, caches, toks[:, S + g], S + g)
        np.testing.assert_allclose(logits.numpy(), full[:, S + g].numpy(), **TOL)


@pytest.mark.parametrize("gate", [0.0, VISION_GATE])
def test_gate_scales_the_cross_layer(gate):
    """At gate 0 (tanh(0) = 0) the logits are the same for two images; at
    0.7 they differ (the check every vision run needs the gate set for)."""
    _, _, _, model, params = _pair(gate=gate)
    cfg = model.cfg
    toks = torch.from_numpy(_prompts(cfg, 2, 6, 6))
    outs = []
    for seed in (1, 2):
        inputs = {k: torch.from_numpy(a) for k, a in context_inputs(cfg, 2, seed=seed).items()}
        outs.append(model.prefill(params, toks, batch_inputs=inputs)[0])
    diff = float((outs[0] - outs[1]).abs().max())
    assert (diff == 0.0) if gate == 0.0 else (diff > 1e-2), diff


def test_init_cache_matches_reference_specs():
    _, model_j, _, model, _ = _pair(10)
    ref = model_j.init_cache(2, 24)
    mine = model.init_cache(2, 24)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), mine) == \
        jax.tree.map(lambda a: (a.shape, a.dtype.name), ref)


def test_bf16_drift_no_more_than_the_references_own():
    """The port's bf16 serve logits drift from the reference's f32 ones no
    more than 2x the reference's own bf16 logits do (bf16_drifts)."""
    port_drift, ref_drift = bf16_drifts(ARCH, _pair())
    assert 0 < port_drift <= 2.0 * ref_drift, (port_drift, ref_drift)
