"""repro_torch's grammar-constrained decoding vs the JAX reference.

The port's copy of ``serving.grammar`` builds the reference's mask and
transition tables array for array; ``ops.sample_tokens(mask=)`` picks the
reference's tokens, greedy and sampled; and the engine under a grammar gives
the JAX engine's tokens and scores on bridged qwen2-0.5b smoke weights in
f32, page 4, with the grammar state carried through single steps and fused
K-step windows alike. A speculating engine decodes grammar requests plainly.
Tolerance: tokens equal, cumulative log-probabilities within 1e-5.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.models import build_model as jax_build, get_config as jax_get_config
from repro.serving import GenerationParams as JaxGenerationParams
from repro.serving import grammar as jgrammar
from repro.serving.engine import (
    EngineConfig as JaxEngineConfig,
    ServeEngine as JaxServeEngine,
)
from repro_torch.kernels import ops
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams, grammar
from repro_torch.serving.engine import EngineConfig, ServeEngine

SCORE_TOL = 1e-5
BASE = dict(num_pages=64, page_size=4, max_batch=8, max_pages_per_seq=8)
CHARMAP = {ch: i for i, ch in enumerate(grammar.JSON_ARRAY_CHARS)}
EOS = len(grammar.JSON_ARRAY_CHARS)
INV = {i: ch for ch, i in CHARMAP.items()}


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    return cfg, (model_j, params_j), (model, params)


def _dfas(mod, vocab, kind, n_items=3):
    if kind == "fixed":
        return mod.fixed_json_array_dfa(CHARMAP, EOS, vocab, n_items=n_items)
    return mod.json_array_dfa(CHARMAP, EOS, vocab)


def _run_both(models, jobs, kind="fixed", **kw):
    """``jobs`` [(prompt, gen kwargs, rid)], every one under the ``kind``
    grammar, through a JAX and a port engine of the same config."""
    cfg, (model_j, params_j), (model, params) = models
    dfa_j, dfa = _dfas(jgrammar, cfg.vocab, kind), _dfas(grammar, cfg.vocab, kind)
    conf = dict(BASE, grammar_states=dfa.n_states, **kw)
    eng_j = JaxServeEngine(model_j, params_j, JaxEngineConfig(**conf))
    eng = ServeEngine(model, params, EngineConfig(**conf), device="cpu")
    hj = {r: eng_j.submit(p, JaxGenerationParams(grammar=dfa_j, **g), rid=r) for p, g, r in jobs}
    ht = {r: eng.submit(p, GenerationParams(grammar=dfa, **g), rid=r) for p, g, r in jobs}
    eng_j.run()
    eng.run()
    for r in jobs:
        a, b = hj[r[2]].sequences[0], ht[r[2]].sequences[0]
        assert b.tokens == a.tokens, r[2]
        assert b.finish_reason == a.finish_reason, r[2]
        assert abs(b.cumulative_logprob - a.cumulative_logprob) <= SCORE_TOL, r[2]
    return {r: h.sequences[0] for r, h in ht.items()}, dfa, eng, eng_j


def _jobs(cfg, n=4, seed=8, n_new=12, **gen):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab, 5).tolist(),
             dict(max_new_tokens=n_new, temperature=0.9, seed=i, eos_id=EOS, **gen), 20 + i)
            for i in range(n)]


# ---------------------------------------------------------------------------------
# the tables
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("kind,n_items", [("fixed", 1), ("fixed", 3), ("fixed", 5),
                                          ("unbounded", 0)])
@pytest.mark.parametrize("vocab", [14, 64, 151936])
def test_dfa_tables_equal_the_reference(kind, n_items, vocab):
    a = _dfas(grammar, vocab, kind, n_items)
    b = _dfas(jgrammar, vocab, kind, n_items)
    assert a.n_states == b.n_states
    assert a.mask.dtype == b.mask.dtype and a.next_state.dtype == b.next_state.dtype
    np.testing.assert_array_equal(a.mask, b.mask)
    np.testing.assert_array_equal(a.next_state, b.next_state)
    walk = [CHARMAP[c] for c in "[1,2,3]"[: 2 * max(n_items, 1) + 1]]
    assert a.valid_prefix(walk) == b.valid_prefix(walk)
    assert a.state_after(walk) == b.state_after(walk)
    assert grammar.MASK_OFF == jgrammar.MASK_OFF


@pytest.mark.parametrize("transitions", [[], [{}], [{9: 0}], [{0: 3}]],
                         ids=["no_states", "empty_state", "token_outside", "state_outside"])
def test_dfa_errors_equal_the_reference(transitions):
    with pytest.raises(ValueError) as want:
        jgrammar.TokenDFA(4, transitions)
    with pytest.raises(ValueError) as got:
        grammar.TokenDFA(4, transitions)
    assert str(got.value) == str(want.value)


# ---------------------------------------------------------------------------------
# sample_tokens(mask=)
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("policy", [dict(temperature=0.0), dict(temperature=0.9),
                                    dict(temperature=1.3, top_k=5), dict(temperature=0.7, top_p=0.8),
                                    dict(temperature=2.0, top_k=3, top_p=0.5)],
                         ids=["greedy", "t0.9", "top_k", "top_p", "top_k_p"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sample_tokens_with_mask_equals_the_reference(policy, seed):
    rng = np.random.default_rng(seed)
    b, vocab, vp = 6, 40, 48
    x = rng.standard_normal((b, vp)).astype(np.float32) * 3
    mask = np.where(rng.random((b, vocab)) < 0.7, grammar.MASK_OFF, 0.0).astype(np.float32)
    mask[0] = 0.0  # an unconstrained row
    mask[1] = grammar.MASK_OFF
    mask[1, 7] = 0.0  # exactly one allowed token
    temp = np.full((b,), policy.get("temperature", 0.0), np.float32)
    temp[2] = 0.0  # a greedy row among sampled ones
    top_k = np.full((b,), policy.get("top_k", 0), np.int32)
    top_p = np.full((b,), policy.get("top_p", 1.0), np.float32)
    seeds = rng.integers(0, 2**32, b, dtype=np.uint64).astype(np.uint32)
    pos = rng.integers(0, 500, b).astype(np.int32)
    want = np.asarray(jops.sample_tokens(
        jnp.asarray(x), jnp.asarray(temp), jnp.asarray(top_k), jnp.asarray(top_p),
        jnp.asarray(seeds), jnp.asarray(pos), vocab=vocab, mask=jnp.asarray(mask)))
    got = ops.sample_tokens(
        torch.from_numpy(x), torch.from_numpy(temp), torch.from_numpy(top_k),
        torch.from_numpy(top_p), torch.from_numpy(seeds.view(np.int32)), torch.from_numpy(pos),
        vocab=vocab, mask=torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(got, want)
    assert got[1] == 7
    assert all(mask[i, got[i]] == 0.0 for i in range(b))
    np.testing.assert_array_equal(  # an all-zero mask is an exact no-op
        ops.sample_tokens(torch.from_numpy(x), torch.from_numpy(temp), torch.from_numpy(top_k),
                          torch.from_numpy(top_p), torch.from_numpy(seeds.view(np.int32)),
                          torch.from_numpy(pos), vocab=vocab,
                          mask=torch.zeros(b, vocab)).numpy(),
        ops.sample_tokens(torch.from_numpy(x), torch.from_numpy(temp), torch.from_numpy(top_k),
                          torch.from_numpy(top_p), torch.from_numpy(seeds.view(np.int32)),
                          torch.from_numpy(pos), vocab=vocab).numpy())


# ---------------------------------------------------------------------------------
# the engine vs the JAX engine
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [False, True], ids=["monolithic", "chunked"])
@pytest.mark.parametrize("k", [1, 4])
def test_grammar_engine_equals_the_jax_engine(models, k, chunked):
    cfg = models[0]
    mode = dict(chunked_prefill=True, chunk_tokens=8) if chunked else {}
    got, dfa, eng, eng_j = _run_both(models, _jobs(cfg), multi_step=k, **mode)
    m, m_j = eng.metrics(), eng_j.metrics()
    assert m["fused_steps"] == m_j["fused_steps"]
    assert (m["fused_steps"] > 0) == (k > 1)
    for seq in got.values():
        assert seq.finish_reason == "eos" and dfa.valid_prefix(seq.tokens)


def test_grammar_and_plain_requests_share_a_batch(models):
    """Grammar rows beside unconstrained ones (state row 0) in one batch, and
    a group under a grammar (each branch carries its own state)."""
    cfg, (model_j, params_j), (model, params) = models
    dfa_j = _dfas(jgrammar, cfg.vocab, "fixed")
    dfa = _dfas(grammar, cfg.vocab, "fixed")
    conf = dict(BASE, grammar_states=dfa.n_states, multi_step=2)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab, 6).tolist() for _ in range(3)]

    def run(eng, params_cls, g):
        hs = [eng.submit(prompts[0], params_cls(max_new_tokens=10, temperature=0.9, seed=3,
                                                eos_id=EOS, grammar=g), rid=0),
              eng.submit(prompts[1], params_cls(max_new_tokens=10), rid=1),
              eng.submit(prompts[2], params_cls(max_new_tokens=10, temperature=0.9, seed=5,
                                                eos_id=EOS, grammar=g, n=3), rid=2)]
        eng.run()
        return [[(s.tokens, s.cumulative_logprob) for s in h.sequences] for h in hs]

    want = run(JaxServeEngine(model_j, params_j, JaxEngineConfig(**conf)),
               JaxGenerationParams, dfa_j)
    got = run(ServeEngine(model, params, EngineConfig(**conf), device="cpu"),
              GenerationParams, dfa)
    for w, g in zip(want, got):
        assert [t for t, _ in g] == [t for t, _ in w]
        np.testing.assert_allclose([c for _, c in g], [c for _, c in w], atol=SCORE_TOL, rtol=0)
    assert all(dfa.valid_prefix(t) for t, _ in got[2])


def test_constrained_decoding_always_parses(models):
    cfg = models[0]
    got, dfa, _, _ = _run_both(models, _jobs(cfg, n=6, seed=12))
    for seq in got.values():
        assert seq.finish_reason == "eos"
        parsed = json.loads("".join(INV[t] for t in seq.tokens if t != EOS))
        assert isinstance(parsed, list) and len(parsed) == 3


def test_unbounded_grammar_yields_valid_prefixes(models):
    cfg = models[0]
    jobs = [(p, dict(g, max_new_tokens=8, temperature=1.0), r)
            for p, g, r in _jobs(cfg, n=3, seed=10)]
    got, dfa, _, _ = _run_both(models, jobs, kind="unbounded")
    for seq in got.values():
        assert dfa.valid_prefix(seq.tokens)
        if seq.finish_reason == "eos":
            json.loads("".join(INV[t] for t in seq.tokens if t != EOS))


def test_grammar_states_overflow_raises_the_reference_error(models):
    cfg, (model_j, params_j), (model, params) = models
    dfa, dfa_j = _dfas(grammar, cfg.vocab, "fixed"), _dfas(jgrammar, cfg.vocab, "fixed")
    conf = dict(BASE, grammar_states=dfa.n_states + 2)
    eng = ServeEngine(model, params, EngineConfig(**conf), device="cpu")
    eng_j = JaxServeEngine(model_j, params_j, JaxEngineConfig(**conf))
    for e, p_cls, d in ((eng, GenerationParams, dfa), (eng_j, JaxGenerationParams, dfa_j)):
        e.submit([1, 2, 3], p_cls(grammar=d, temperature=0.5))
        e.submit([1, 2, 3], p_cls(grammar=d, temperature=0.5))  # the same automaton: no new rows
    other, other_j = _dfas(grammar, cfg.vocab, "unbounded"), _dfas(jgrammar, cfg.vocab, "unbounded")
    with pytest.raises(ValueError) as want:
        eng_j.submit([1, 2, 3], JaxGenerationParams(grammar=other_j, temperature=0.5))
    with pytest.raises(ValueError) as got:
        eng.submit([1, 2, 3], GenerationParams(grammar=other, temperature=0.5))
    assert str(got.value) == str(want.value) and "raise grammar_states" in str(got.value)
    plain = ServeEngine(model, params, EngineConfig(**BASE), device="cpu")
    with pytest.raises(ValueError, match="grammar_states=0"):
        plain.submit([1, 2, 3], GenerationParams(grammar=dfa, temperature=0.5))
    small = _dfas(grammar, 14, "fixed")
    with pytest.raises(ValueError, match="vocab"):
        eng.submit([1, 2, 3], GenerationParams(grammar=small, temperature=0.5))


def test_speculating_engine_decodes_grammar_requests_plainly(models):
    cfg = models[0]
    got, dfa, eng, eng_j = _run_both(models, _jobs(cfg, n=2, seed=14), spec_tokens=3,
                                     multi_step=2, spec_backoff=0)
    m, m_j = eng.metrics(), eng_j.metrics()
    assert m["spec_windows"] == m_j["spec_windows"] == 0
    assert m["decode_steps"] == m_j["decode_steps"] > 0
