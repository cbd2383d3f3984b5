"""whisper-large-v3 (the encoder-decoder family) in repro_torch against the
JAX package, on the whisper-smoke config (2 encoder + 2 decoder layers,
d_model 64, 4 heads of 16, enc_seq 12, layernorm, the plain gelu MLP).

The weights are the port's seeded init as the reference's tree
(``bridged_pair``); frames and prompts are numpy draws from a seed, fed in
the param dtype to both. What must agree, in f32 within 1e-4 (the two
packages sum in different orders): the encoder's output (``encode_ctx``:
sinusoidal table, non-causal self-attention with RoPE, final norm) on its
own; ``make_prefill(max_len)(..., batch_inputs=)`` then ``make_serve_step``
logits a step, 8 greedy tokens equal, and the caches leaf by leaf ({"self",
"cross"}, the cross K/V in the param dtype); the same with int8 MLP weights
(``build_model(cfg, quantized=True)``). The port's prefill + decode equals
its own ``forward(ctx=)``. In bf16 the port's drift from the reference's f32
logits stays within 2x the reference's own bf16 drift (as
test_torch_bf16_parity.py).
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
    assert_caches_equal, bf16_drifts, bridged_pair, context_inputs, serve_pair,
)

ARCH = "whisper-large-v3"
TOL = dict(rtol=1e-4, atol=1e-4)
STEPS = 8
_PAIRS = {}


def _pair(**kw):
    key = tuple(sorted(kw.items()))
    if key not in _PAIRS:
        _PAIRS[key] = bridged_pair(ARCH, **kw)
    return _PAIRS[key]


def _prompts(cfg, batch, length, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=(batch, length)).astype(
        np.int32)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    ref, cfg = jax_get_config(ARCH, smoke=smoke), get_config(ARCH, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    assert {f.name for f in dataclasses.fields(ModelConfig)} == \
        {f.name for f in dataclasses.fields(type(ref))}
    assert block_program(cfg) == [("dec", cfg.n_layers)]
    if not smoke:
        assert (cfg.n_layers, cfg.n_enc_layers, cfg.d_model, cfg.n_heads, cfg.head_dim,
                cfg.d_ff, cfg.enc_seq, cfg.mlp_act, cfg.norm) == \
            (32, 32, 1280, 20, 64, 5120, 1500, "gelu", "layernorm")


def test_bridge_carries_the_encoder():
    """The encoder subtree splits on its layer dim, value for value."""
    cfg, _, params_j, _, params = _pair()
    enc = params["encoder"]
    assert len(enc["blocks"]) == 1 and len(enc["blocks"][0]) == cfg.n_enc_layers
    for l in range(cfg.n_enc_layers):
        np.testing.assert_array_equal(
            enc["blocks"][0][l]["attn"]["wq"].numpy(),
            np.asarray(params_j["encoder"]["blocks"][0]["attn"]["wq"])[l])
        assert sorted(enc["blocks"][0][l]["mlp"]) == ["b_down", "b_up", "w_down", "w_up"]
    np.testing.assert_array_equal(enc["final_norm"]["bias"].numpy(),
                                  np.asarray(params_j["encoder"]["final_norm"]["bias"]))


def test_encode_ctx_matches_reference():
    """The encoder alone (a wrong RoPE or sinusoidal table would still give
    plausible logits)."""
    cfg, model_j, params_j, model, params = _pair()
    frames = context_inputs(cfg, 2, seed=1)["frames"]
    want = model_j.encode_ctx(params_j, {"frames": jnp.asarray(frames)})
    got = model.encode_ctx(params, {"frames": torch.from_numpy(frames)})
    assert got.shape == (2, cfg.enc_seq, cfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("length", [7, 16])
def test_greedy_serve_matches_reference(length):
    pair = _pair()
    cfg = pair[0]
    got, want, toks_t, toks_j, ct, cj = serve_pair(
        pair, _prompts(cfg, 2, length, length), context_inputs(cfg, 2, seed=length), STEPS)
    np.testing.assert_allclose(got, want, **TOL)
    assert toks_t == toks_j and len(toks_t) == STEPS
    assert_caches_equal(ct, cj, rtol=1e-4, atol=2e-4)
    assert sorted(ct[0]) == ["cross", "self"]
    assert ct[0]["cross"]["k"].shape == (cfg.n_layers, 2, cfg.n_kv_heads, cfg.enc_seq,
                                         cfg.head_dim)


def test_quantized_serve_matches_reference():
    """int8 w_up / w_down in every encoder and decoder layer, the plain
    quant_matmul on the CPU against the reference's quantized model."""
    pair = _pair(quantized=True)
    cfg, params = pair[0], pair[4]
    assert isinstance(params["blocks"][0][0]["mlp"]["w_up"], dict)
    assert isinstance(params["encoder"]["blocks"][0][0]["mlp"]["w_down"], dict)
    got, want, toks_t, toks_j, _, _ = serve_pair(
        pair, _prompts(cfg, 2, 9, 3), context_inputs(cfg, 2, seed=3), STEPS)
    np.testing.assert_allclose(got, want, **TOL)
    assert toks_t == toks_j


def test_prefill_decode_matches_forward():
    """The port against itself: each decode step's logits equal the full
    forward's row at that position, over the same encoder context."""
    cfg, _, _, model, params = _pair()
    toks = torch.from_numpy(_prompts(cfg, 2, 20, 5)).long()
    inputs = {k: torch.from_numpy(a) for k, a in context_inputs(cfg, 2, seed=5).items()}
    S, G = 16, 4
    full, _ = model.forward(params, toks, ctx=model.encode_ctx(params, inputs))
    _, caches = model.prefill(params, toks[:, :S], batch_inputs=inputs, max_len=S + G)
    for g in range(G):
        logits, caches = model.decode_step(params, caches, toks[:, S + g], S + g)
        np.testing.assert_allclose(logits.numpy(), full[:, S + g].numpy(), **TOL)


def test_init_cache_matches_reference_specs():
    cfg, model_j, _, model, _ = _pair()
    ref = model_j.init_cache(2, 24)
    mine = model.init_cache(2, 24)
    assert jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), mine) == \
        jax.tree.map(lambda a: (a.shape, a.dtype.name), ref)


def test_bf16_drift_no_more_than_the_references_own():
    """The port's bf16 serve logits drift from the reference's f32 ones no
    more than 2x the reference's own bf16 logits do (bf16_drifts)."""
    port_drift, ref_drift = bf16_drifts(ARCH, _pair())
    assert 0 < port_drift <= 2.0 * ref_drift, (port_drift, ref_drift)
