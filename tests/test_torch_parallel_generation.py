"""repro_torch's parallel generation (best-of-n and beam search on forked
block-table rows) vs the JAX reference.

``GenerationParams`` validation raises the reference's errors;
``PagedKVCache.fork_slot`` / ``reorder_rows`` leave the reference cache's
tables, lengths and refcounts after the same operations; and the engine's
best-of-n and beam groups give the JAX engine's tokens and scores on bridged
qwen2-0.5b smoke weights in f32, page 4, in both prefill regimes, through
whole-group preemption in a tight pool too. Tolerance: tokens equal,
cumulative log-probabilities within 1e-5.
"""
import dataclasses

import jax
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import build_model as jax_build, get_config as jax_get_config
from repro.serving import GenerationParams as JaxGenerationParams, TokenDFA as JaxTokenDFA
from repro.serving.engine import (
    EngineConfig as JaxEngineConfig,
    ServeEngine as JaxServeEngine,
)
from repro.serving.engine.cache import PagedKVCache as JaxPagedKVCache
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams, TokenDFA
from repro_torch.serving.engine import EngineConfig, PagedKVCache, ServeEngine

SCORE_TOL = 1e-5
BASE = dict(num_pages=64, page_size=4, max_batch=8, max_pages_per_seq=8)
MODES = {"monolithic": {}, "chunked": dict(chunked_prefill=True, chunk_tokens=8)}
SAMPLE = dict(temperature=0.8, top_k=8)


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    return cfg, (model_j, params_j), (model, params)


def _engines(models, **kw):
    cfg, (model_j, params_j), (model, params) = models
    conf = dict(BASE, **kw)
    return (JaxServeEngine(model_j, params_j, JaxEngineConfig(**conf)),
            ServeEngine(model, params, EngineConfig(**conf), device="cpu"))


def _run_both(models, jobs, **kw):
    """Submit ``jobs`` [(prompt, gen kwargs, rid)] to a JAX and a port engine
    of the same config; returns (jax sequences, port sequences, jax engine,
    port engine), sequences keyed by rid."""
    eng_j, eng = _engines(models, **kw)
    hj = {rid: eng_j.submit(p, JaxGenerationParams(**g), rid=rid) for p, g, rid in jobs}
    ht = {rid: eng.submit(p, GenerationParams(**g), rid=rid) for p, g, rid in jobs}
    eng_j.run()
    eng.run()
    return ({r: h.sequences for r, h in hj.items()}, {r: h.sequences for r, h in ht.items()},
            eng_j, eng)


def _same_sequences(want, got):
    assert sorted(want) == sorted(got)
    for rid in want:
        assert len(got[rid]) == len(want[rid]), rid
        for b, (w, g) in enumerate(zip(want[rid], got[rid])):
            assert g.tokens == w.tokens, (rid, b)
            assert g.finish_reason == w.finish_reason, (rid, b)
            assert abs(g.cumulative_logprob - w.cumulative_logprob) <= SCORE_TOL, (rid, b)


def _prompt(cfg, seed, n):
    return np.random.default_rng(seed).integers(0, cfg.vocab, n).tolist()


# ---------------------------------------------------------------------------------
# GenerationParams: the reference's error types and messages
# ---------------------------------------------------------------------------------
REFUSED = {
    "beam_width_1": dict(beam_width=1),
    "beam_negative": dict(beam_width=-2),
    "beam_sampled": dict(beam_width=2, temperature=0.7),
    "beam_top_k": dict(beam_width=2, top_k=5),
    "beam_top_p": dict(beam_width=2, top_p=0.9),
    "n_above_beam": dict(beam_width=2, n=3),
    "beam_grammar": dict(beam_width=2, grammar="dfa"),
    "beam_logprobs": dict(beam_width=2, logprobs=3),
    "n_greedy": dict(n=2),
    "n_zero": dict(n=0),
    "spec_beam": dict(beam_width=2, speculative=True),
    "spec_grammar": dict(grammar="dfa", speculative=True),
    "max_new_zero": dict(max_new_tokens=0),
    "negative_temperature": dict(temperature=-1.0),
}


@pytest.mark.parametrize("kw", list(REFUSED.values()), ids=list(REFUSED))
def test_params_validation_raises_the_reference_errors(kw):
    def build(cls, dfa_cls):
        args = {k: (dfa_cls(4, [{0: 0}]) if v == "dfa" else v) for k, v in kw.items()}
        with pytest.raises(Exception) as info:
            cls(**args)
        return info

    want, got = build(JaxGenerationParams, JaxTokenDFA), build(GenerationParams, TokenDFA)
    assert got.type is want.type
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("kw,branches", [
    (dict(n=4, temperature=0.5), 4), (dict(beam_width=4, n=2), 4), (dict(beam_width=3), 3),
    (dict(n=1), 1), (dict(grammar="dfa", temperature=0.9), 1),
])
def test_params_accepted_with_the_reference_branch_count(kw, branches):
    args = {k: (TokenDFA(4, [{0: 0}]) if v == "dfa" else v) for k, v in kw.items()}
    jargs = {k: (JaxTokenDFA(4, [{0: 0}]) if v == "dfa" else v) for k, v in kw.items()}
    assert GenerationParams(**args).n_branches == JaxGenerationParams(**jargs).n_branches == branches


def test_engine_config_accepts_the_slice_and_refuses_item_7(models):
    cfg, _, (model, params) = models
    eng = ServeEngine(model, params, EngineConfig(**BASE, host_pool_pages=8, max_beam_width=4,
                                                  grammar_states=6), device="cpu")
    assert eng.cache.tier is not None and eng._lp_k == 5
    for field in ("autotune", "record_logits"):
        assert getattr(EngineConfig(**{field: True}), field) is True
    with pytest.raises(ValueError, match="prefix_sharing"):
        ServeEngine(model, params, EngineConfig(**BASE, host_pool_pages=8, prefix_sharing=False),
                    device="cpu")


# ---------------------------------------------------------------------------------
# fork_slot / reorder_rows vs the reference cache on the same operations
# ---------------------------------------------------------------------------------
def _alloc(c, slot, n):
    c.allocate(slot, c.pages_for(n + 1), tokens=list(range(100 * slot, 100 * slot + n)))
    c.set_len(slot, n)


OPS = {  # each a list of (method, args); both caches run the same list
    "fork_partial": [("alloc", (0, 7)), ("fork_slot", (0, 1, 7)), ("fork_slot", (0, 2, 7))],
    "fork_aligned": [("alloc", (0, 8)), ("fork_slot", (0, 1, 8)), ("fork_slot", (0, 2, 8))],
    "fork_then_cow": [("alloc", (0, 7)), ("fork_slot", (0, 1, 7)), ("cow_page", (1,)),
                      ("fork_slot", (0, 2, 7)), ("cow_page", (2,))],
    "reorder_onto_one": [("alloc", (0, 8)), ("fork_slot", (0, 1, 8)), ("fork_slot", (0, 2, 8)),
                         ("reorder_rows", ({1: 0, 2: 0},))],
    "reorder_swap": [("alloc", (0, 8)), ("alloc", (1, 9)), ("reorder_rows", ({0: 1, 1: 0},))],
    "reorder_cycle": [("alloc", (0, 5)), ("alloc", (1, 9)), ("alloc", (2, 13)),
                      ("reorder_rows", ({0: 1, 1: 2, 2: 0},))],
    "reorder_identity": [("alloc", (0, 8)), ("fork_slot", (0, 1, 8)),
                         ("reorder_rows", ({0: 0, 1: 1},))],
    "fork_reorder_free": [("alloc", (0, 11)), ("fork_slot", (0, 1, 11)), ("cow_page", (1,)),
                          ("reorder_rows", ({0: 1},)), ("free_slot", (1,)), ("fork_slot", (0, 3, 11)),
                          ("free_slot", (0,))],
}


@pytest.mark.parametrize("ops", list(OPS.values()), ids=list(OPS))
def test_fork_and_reorder_equal_the_reference_cache(models, ops):
    cfg, (model_j, _), (model, _) = models
    kw = dict(num_pages=24, page_size=4, max_batch=4, max_pages_per_seq=8)
    mine, ref = PagedKVCache(model, **kw), JaxPagedKVCache(model_j, **kw)
    for name, args in ops:
        for c in (mine, ref):
            if name == "alloc":
                _alloc(c, *args)
            else:
                getattr(c, name)(*args)
        np.testing.assert_array_equal(mine.tables, ref.tables)
        np.testing.assert_array_equal(mine.lens, ref.lens)
        np.testing.assert_array_equal(mine.ref, ref.ref)
        assert mine.pages_of == ref.pages_of and mine.num_free == ref.num_free
    st_m, st_r = mine.stats(), ref.stats()
    for k in ("branch_forks", "beam_reorders", "cow_copies", "pages_shared", "peak_pages_in_use"):
        assert st_m[k] == st_r[k], k
    tables, lens = mine.device_state()
    np.testing.assert_array_equal(tables.numpy(), mine.tables)
    np.testing.assert_array_equal(lens.numpy(), mine.lens)


def test_fork_copies_nothing_and_cow_copies_the_shared_partial_page(models):
    cfg, _, (model, _) = models
    c = PagedKVCache(model, num_pages=16, page_size=4, max_batch=4, max_pages_per_seq=8)
    _alloc(c, 0, 7)
    for t in c.pools[0].values():
        t.normal_()
    c.fork_slot(0, 1, 7)
    assert c.pages_of[1] == c.pages_of[0] and c.needs_cow(1)
    old = c.pages_of[1][1]
    assert c.cow_page(1)
    new = c.pages_of[1][1]
    assert new != old and c.ref[old] == 1 and c.ref[new] == 1
    for t in c.pools[0].values():
        assert torch.equal(t[:, new], t[:, old])
    with pytest.raises(RuntimeError, match="pool exhausted"):
        small = PagedKVCache(model, num_pages=4, page_size=4, max_batch=2, max_pages_per_seq=4)
        _alloc(small, 0, 8)
        small.fork_slot(0, 1, 8)


# ---------------------------------------------------------------------------------
# the engine vs the JAX engine
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("prompt_len", [7, 8])  # a partial and an aligned last page
def test_best_of_n_equals_the_jax_engine(models, prompt_len, mode):
    cfg = models[0]
    prompt = _prompt(cfg, 3, prompt_len)
    want, got, eng_j, eng = _run_both(
        models, [(prompt, dict(max_new_tokens=6, seed=123, n=4, **SAMPLE), 7)], **MODES[mode])
    _same_sequences(want, got)
    assert len(got[7]) == 4
    m, m_j = eng.metrics(), eng_j.metrics()
    for k in ("branch_forks", "cow_copies", "pages_shared", "peak_pages_in_use",
              "generated_tokens"):
        assert m[k] == m_j[k], k
    assert m["branch_forks"] == 3


def test_best_of_n_branch_equals_serial_request_at_seed_plus_b(models):
    """Branch b of an n-branch request equals a serial n=1 request at
    seed + b with the same rid (the branch-seed law)."""
    cfg, _, (model, params) = models
    prompt = _prompt(cfg, 3, 7)
    eng = ServeEngine(model, params, EngineConfig(**BASE), device="cpu")
    h = eng.submit(prompt, GenerationParams(max_new_tokens=6, seed=123, n=4, **SAMPLE), rid=7)
    eng.run()
    for b, seq in enumerate(h.sequences):
        solo = ServeEngine(model, params, EngineConfig(**BASE), device="cpu")
        hs = solo.submit(prompt, GenerationParams(max_new_tokens=6, seed=123 + b, **SAMPLE),
                         rid=7)
        solo.run()
        assert seq.tokens == hs.sequences[0].tokens, b
        assert seq.cumulative_logprob == hs.sequences[0].cumulative_logprob, b


def test_best_of_n_shares_the_prompt_pages(models):
    cfg, _, (model, params) = models
    prompt = _prompt(cfg, 4, 24)
    eng = ServeEngine(model, params, EngineConfig(**dict(BASE, num_pages=128,
                                                         max_pages_per_seq=16)), device="cpu")
    eng.submit(prompt, GenerationParams(max_new_tokens=4, temperature=0.7, top_k=8, seed=5, n=8),
               rid=3)
    eng.run()
    st = eng.cache.stats()
    assert st["branch_forks"] == 7
    assert st["peak_pages_in_use"] <= 6 * 1.25 + 8 * 2 < 8 * 6


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("width,n", [(4, 2), (2, 2)])
def test_beam_equals_the_jax_engine(models, width, n, mode):
    cfg = models[0]
    prompt = _prompt(cfg, 7, 6)
    want, got, eng_j, eng = _run_both(
        models, [(prompt, dict(max_new_tokens=5, beam_width=width, n=n), 11)],
        max_beam_width=4, **MODES[mode])
    _same_sequences(want, got)
    assert len(got[11]) == n
    assert got[11][0].cumulative_logprob >= got[11][-1].cumulative_logprob
    m, m_j = eng.metrics(), eng_j.metrics()
    for k in ("beam_reorders", "branch_forks", "cow_copies", "fused_steps"):
        assert m[k] == m_j[k], k
    assert m["beam_reorders"] >= 1 and m["fused_steps"] == 0


def test_beam_with_eos_and_a_plain_request_equals_the_jax_engine(models):
    """Beam hypotheses ending in eos move to the finished pool; a plain
    request and a best-of-n group share the batch, multi_step 4 (the beam
    group refuses fusion)."""
    cfg, _, (model, params) = models
    prompt = _prompt(cfg, 8, 9)
    probe = ServeEngine(model, params, EngineConfig(**BASE, max_beam_width=3), device="cpu")
    hp = probe.submit(prompt, GenerationParams(max_new_tokens=6, beam_width=3, n=3), rid=0)
    probe.run()
    eos = hp.sequences[0].tokens[2]
    jobs = [(prompt, dict(max_new_tokens=6, beam_width=3, n=3, eos_id=eos), 0),
            (_prompt(cfg, 9, 5), dict(max_new_tokens=6), 1),
            (_prompt(cfg, 10, 6), dict(max_new_tokens=5, seed=4, n=2, **SAMPLE), 2)]
    want, got, eng_j, eng = _run_both(models, jobs, max_beam_width=3, multi_step=4)
    _same_sequences(want, got)
    assert any(s.finish_reason == "eos" for s in got[0])
    assert eng.metrics()["beam_reorders"] == eng_j.metrics()["beam_reorders"]


def test_branch_eos_does_not_disturb_its_siblings(models):
    cfg, _, (model, params) = models
    prompt = _prompt(cfg, 5, 7)

    def serial(seed, eos=None):
        eng = ServeEngine(model, params, EngineConfig(**BASE), device="cpu")
        h = eng.submit(prompt, GenerationParams(max_new_tokens=6, seed=seed, eos_id=eos,
                                                **SAMPLE), rid=9)
        eng.run()
        return h.sequences[0].tokens

    base = serial(50)
    eos = base[2]
    sib = serial(51, eos)
    want, got, _, eng = _run_both(
        models, [(prompt, dict(max_new_tokens=6, seed=50, n=2, eos_id=eos, **SAMPLE), 9)])
    _same_sequences(want, got)
    assert got[9][0].tokens == base[:3] and got[9][0].finish_reason == "eos"
    assert got[9][1].tokens == sib
    assert eng.cache.num_free == eng.cache.num_pages - 1


def test_group_that_can_never_fit_is_rejected_at_enqueue(models):
    cfg, _, (model, params) = models
    prompt = _prompt(cfg, 6, 40)
    eng = ServeEngine(model, params, EngineConfig(**dict(BASE, num_pages=8,
                                                         max_pages_per_seq=16)), device="cpu")
    with pytest.raises(ValueError, match="across 2 branches"):
        eng.submit(prompt, GenerationParams(max_new_tokens=4, temperature=0.5, n=2), rid=1)
    with pytest.raises(ValueError, match="max_beam_width"):
        eng.submit([1, 2, 3], GenerationParams(beam_width=4, max_new_tokens=2))
    with pytest.raises(ValueError, match="max_batch"):
        ServeEngine(model, params, EngineConfig(**dict(BASE, max_batch=2)), device="cpu").submit(
            [1, 2, 3], GenerationParams(n=3, temperature=0.5))


@pytest.mark.parametrize("mode", list(MODES))
def test_group_preempted_in_a_tight_pool_equals_the_jax_engine(models, mode):
    """A pool too small for everyone: whole groups are preempted (a sample
    group and a beam group beside plain requests), re-admitted, their diverged
    branches re-prefilled and their fresh ones re-forked."""
    cfg = models[0]
    jobs = [(_prompt(cfg, 20, 9), dict(max_new_tokens=8, seed=1, n=3, **SAMPLE), 0),
            (_prompt(cfg, 21, 6), dict(max_new_tokens=8, beam_width=2), 1),
            (_prompt(cfg, 22, 10), dict(max_new_tokens=8), 2),
            (_prompt(cfg, 23, 7), dict(max_new_tokens=8, seed=2, n=2, **SAMPLE), 3)]
    want, got, eng_j, eng = _run_both(models, jobs, num_pages=14, max_batch=6,
                                      max_beam_width=2, **MODES[mode])
    _same_sequences(want, got)
    m, m_j = eng.metrics(), eng_j.metrics()
    assert m["preemptions"] == m_j["preemptions"] >= 1
    for k in ("branch_forks", "beam_reorders", "cow_copies"):
        assert m[k] == m_j[k], k
    eng.cache.check_conservation()
    assert eng.cache.num_free == eng.cache.num_pages - 1
