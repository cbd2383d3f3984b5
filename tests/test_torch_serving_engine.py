"""repro_torch's ServeEngine vs the JAX reference engine on bridged weights.

Each scenario runs once through the reference ServeEngine (module fixture)
and through the port's ServeEngine(device="cpu"); greedy tokens must be
identical. The scenarios are the reference's own engine tests: mixed prompt
lengths, preemption under page pressure, prefix sharing with forced
copy-on-write, sharing under preemption, and chunked prefill with shared-prefix
compute skip and mid-prefill preemption. Allocator invariants are checked
after every decode step. Sampled streams (temperature, top-k, top-p) are
identical to the reference's too: the port's Gumbel noise is JAX's threefry
stream bit for bit.
"""
import dataclasses

import jax
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
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams
from repro_torch.serving.engine import (
    PREFILLING,
    EngineConfig,
    Request,
    ServeEngine,
    validate_chrome_trace,
)


def _scenarios(vocab):
    """name -> (requests [(prompt, max_new_tokens)], EngineConfig kwargs)."""
    out = {}
    rng = np.random.default_rng(0)
    out["mixed_lengths"] = (
        [(rng.integers(0, vocab, size=L).tolist(), 6) for L in (5, 9, 16, 3, 12)],
        dict(num_pages=32, page_size=4, max_batch=4, max_pages_per_seq=8),
    )
    rng = np.random.default_rng(1)
    out["preemption"] = (
        [(rng.integers(0, vocab, size=8).tolist(), 10) for _ in range(3)],
        dict(num_pages=10, page_size=4, max_batch=3, max_pages_per_seq=6),
    )
    rng = np.random.default_rng(4)
    prompt = rng.integers(0, vocab, size=10).tolist()  # 10 % 4 != 0: partial page shared
    out["forced_cow"] = (
        [(list(prompt), 6) for _ in range(3)],
        dict(num_pages=32, page_size=4, max_batch=3, max_pages_per_seq=8),
    )
    rng = np.random.default_rng(5)
    prefix = rng.integers(0, vocab, size=8).tolist()
    out["sharing_preemption"] = (
        [(prefix + rng.integers(0, vocab, size=2).tolist(), 10) for _ in range(3)],
        dict(num_pages=11, page_size=4, max_batch=3, max_pages_per_seq=6),
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
    rng = np.random.default_rng(7)
    out["chunked_preempt_mid_prefill"] = (
        [(rng.integers(0, vocab, size=44).tolist(), 4), (rng.integers(0, vocab, size=4).tolist(), 10)],
        dict(num_pages=16, page_size=4, max_batch=2, max_pages_per_seq=12,
             chunked_prefill=True, chunk_tokens=4),
    )
    return out


SCENARIOS = list(_scenarios(512))
SAMPLING = dict(temperature=0.9, top_k=20, top_p=0.95, seed=11)
SAMPLED_SCENARIOS = ("mixed_lengths", "preemption")


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    scenarios = _scenarios(cfg.vocab)
    reference, reference_metrics = {}, {}
    runs = [(name, name, {}) for name in scenarios]
    runs += [(("sampled", name), name, SAMPLING) for name in SAMPLED_SCENARIOS]
    for key, name, gen in runs:
        spec, kw = scenarios[name]
        eng = JaxServeEngine(model_j, params_j, JaxEngineConfig(**kw))
        res = eng.run([
            JaxRequest(rid=i, prompt=list(p),
                       params=JaxGenerationParams(max_new_tokens=n, **gen))
            for i, (p, n) in enumerate(spec)
        ])
        reference[key] = {i: list(res[i].generated) for i in res}
        reference_metrics[key] = eng.metrics()
    return cfg, model, params, scenarios, reference, reference_metrics


def _requests(spec, **gen):
    return [Request(rid=i, prompt=list(p), params=GenerationParams(max_new_tokens=n, **gen))
            for i, (p, n) in enumerate(spec)]


def _checked_engine(model, params, config):
    """An engine whose allocator invariants are checked after every decode step."""
    eng = ServeEngine(model, params, config, device="cpu")
    decode = eng._decode_once

    def checked():
        decode()
        eng.cache.check_conservation()
        assert (eng.cache.ref >= 0).all()
        live = int((eng.cache.ref[1:] > 0).sum())
        assert live + eng.cache.num_free == eng.cache.num_pages - 1

    eng._decode_once = checked
    return eng


@pytest.mark.parametrize("name", SCENARIOS)
def test_engine_greedy_tokens_identical_to_reference(setup, name):
    cfg, model, params, scenarios, reference, _ = setup
    spec, kw = scenarios[name]
    eng = _checked_engine(model, params, EngineConfig(**kw))
    results = eng.run(_requests(spec))
    assert {i: results[i].generated for i in results} == reference[name]
    m = eng.metrics()
    assert m["requests"] == len(spec) and m["failed"] == 0
    assert m["generated_tokens"] == sum(n for _, n in spec)
    # every page returns to the free list once the engine drains
    assert eng.cache.num_free == eng.cache.num_pages - 1 and int(eng.cache.ref.sum()) == 0
    if name in ("preemption", "sharing_preemption", "chunked_preempt_mid_prefill"):
        assert m["preemptions"] >= 1
    if name == "forced_cow":
        assert m["cow_copies"] >= 2 and m["pages_shared"] >= 6
    if name in ("sharing_preemption", "chunked_skip"):
        assert m["pages_shared"] > 0
    if name == "chunked_skip":
        assert m["prefill_tokens_skipped"] > 0


def test_twin_adoption_matches_reference_metrics(setup):
    """Same-step twin adoption: on the staggered-prefix workload a twin
    admitted with its donor adopts the donor's in-flight pages, so the port
    shares and skips exactly as much as the reference, with identical
    tokens."""
    cfg, model, params, scenarios, reference, reference_metrics = setup
    spec, kw = scenarios["chunked_skip"]
    eng = ServeEngine(model, params, EngineConfig(**kw, trace=True), device="cpu")
    results = eng.run(_requests(spec))
    assert {i: results[i].generated for i in results} == reference["chunked_skip"]
    mine, ref = eng.metrics(), reference_metrics["chunked_skip"]
    assert mine["prefill_tokens_skipped"] == ref["prefill_tokens_skipped"] > 0
    assert mine["pages_shared"] == ref["pages_shared"] > 0
    assert eng.trace.count("twin_adopt") >= 1


def test_broken_twin_is_requeued_and_stays_exact(setup):
    """A twin whose donor is preempted before writing the adopted pages is
    evicted and re-admitted; its tokens stay the reference's."""
    cfg, model, params, scenarios, reference, _ = setup
    spec, kw = scenarios["chunked_skip"]
    eng = ServeEngine(model, params, EngineConfig(**kw, trace=True), device="cpu")
    cache, chunks = eng.cache, eng._prefill_chunks
    killed = []

    def chunks_then_kill_donor(now):
        chunks(now)  # then preempt the donor, as a decode page shortage would
        for adopter, (donor, _) in list(cache._frontier_deps.items()):
            if not killed:
                killed.append(adopter)
                eng.scheduler.preempt_slot(donor, eng.queue)

    eng._prefill_chunks = chunks_then_kill_donor
    results = eng.run(_requests(spec))
    assert killed and eng.trace.count("preempt") >= 2
    assert {i: results[i].generated for i in results} == reference["chunked_skip"]
    assert cache.num_free == cache.num_pages - 1 and not cache._inflight


def test_chunked_preemption_hits_a_prefilling_slot(setup):
    cfg, model, params, scenarios, reference, _ = setup
    spec, kw = scenarios["chunked_preempt_mid_prefill"]
    eng = ServeEngine(model, params, EngineConfig(**kw), device="cpu")
    phases = []
    orig = eng.scheduler._preempt_one

    def spy(queue, keep_slot):
        victims = [s for s in eng.scheduler.running if s != keep_slot]
        if victims:
            phases.append(eng.scheduler.running[victims[-1]].phase)
        return orig(queue, keep_slot)

    eng.scheduler._preempt_one = spy
    results = eng.run(_requests(spec))
    assert PREFILLING in phases
    assert {i: results[i].generated for i in results} == reference["chunked_preempt_mid_prefill"]


def test_prefix_sharing_saves_pages_and_stays_exact(setup):
    cfg, model, params, scenarios, reference, _ = setup
    rng = np.random.default_rng(3)
    prefix = rng.integers(0, cfg.vocab, size=16).tolist()
    spec = [(prefix + rng.integers(0, cfg.vocab, size=4).tolist(), 5) for _ in range(4)]
    kw = dict(num_pages=48, page_size=4, max_batch=4, max_pages_per_seq=8)
    on = ServeEngine(model, params, EngineConfig(**kw), device="cpu")
    off = ServeEngine(model, params, EngineConfig(**kw, prefix_sharing=False), device="cpu")
    res_on, res_off = on.run(_requests(spec)), off.run(_requests(spec))
    for i in range(len(spec)):
        assert res_on[i].generated == res_off[i].generated
    m_on, m_off = on.metrics(), off.metrics()
    assert m_on["pages_shared"] > 0 and m_off["pages_shared"] == 0
    assert m_on["peak_pages_in_use"] <= m_off["peak_pages_in_use"] - 12


def test_cache_dense_view_matches_prefill(setup):
    cfg, model, params, _, _, _ = setup
    prompt = np.random.default_rng(2).integers(0, cfg.vocab, size=10).tolist()
    eng = ServeEngine(model, params, EngineConfig(num_pages=16, page_size=4, max_batch=2,
                                                  max_pages_per_seq=8), device="cpu")
    eng.submit(Request(rid=0, prompt=prompt, params=GenerationParams(max_new_tokens=1)))
    eng.queue.push(eng._pending.pop())
    eng._admit_and_prefill(0.0)
    k_paged, v_paged = eng.cache.dense_view(0)
    _, caches = model.prefill(params, torch.tensor([prompt]), max_len=12)
    np.testing.assert_allclose(k_paged.numpy(), caches[0]["k"][0, 0, :, :10].numpy(), atol=1e-6)
    np.testing.assert_allclose(v_paged.numpy(), caches[0]["v"][0, 0, :, :10].numpy(), atol=1e-6)


def _sampled_run(model, params, spec, **kw):
    eng = ServeEngine(model, params, EngineConfig(**kw), device="cpu")
    res = eng.run(_requests(spec, **SAMPLING))
    return {i: res[i].generated for i in res}, eng.metrics()


@pytest.mark.parametrize("name", SAMPLED_SCENARIOS)
def test_sampled_tokens_identical_to_reference(setup, name):
    cfg, model, params, scenarios, reference, _ = setup
    spec, kw = scenarios[name]
    got, _ = _sampled_run(model, params, spec, **kw)
    assert got == reference[("sampled", name)]
    assert got != reference[name]  # sampling is really on


def test_sampled_streams_reproduce_across_runs(setup):
    cfg, model, params, scenarios, _, _ = setup
    spec, kw = scenarios["mixed_lengths"]
    a, _ = _sampled_run(model, params, spec, **kw)
    b, _ = _sampled_run(model, params, spec, **kw)
    assert a == b
    greedy = ServeEngine(model, params, EngineConfig(**kw), device="cpu").run(_requests(spec))
    assert any(a[i] != greedy[i].generated for i in a)  # sampling is really on


def test_sampled_streams_invariant_under_preemption(setup):
    cfg, model, params, scenarios, _, _ = setup
    spec, kw = scenarios["preemption"]
    roomy, m_roomy = _sampled_run(model, params, spec, **dict(kw, num_pages=40))
    tight, m_tight = _sampled_run(model, params, spec, **kw)
    assert m_roomy["preemptions"] == 0 and m_tight["preemptions"] >= 1
    assert roomy == tight


def test_trace_exports_valid_chrome_json(setup):
    cfg, model, params, scenarios, _, _ = setup
    spec, kw = scenarios["preemption"]
    eng = ServeEngine(model, params, EngineConfig(**kw, trace=True), device="cpu")
    eng.run(_requests(spec))
    validate_chrome_trace(eng.trace.to_chrome())
    assert eng.trace.count("preempt") >= 1 and eng.trace.count("decode", "B") >= 1


@pytest.mark.parametrize("field,value", [
    ("host_pool_pages", 8), ("grammar_states", 4), ("max_beam_width", 2), ("autotune", True),
    ("record_logits", True),
])
def test_unported_engine_options_raise(field, value):
    """Every engine option of the reference is ported now: the host tier,
    constrained decoding, beam search, autotuning and logits recording are
    accepted, and a config holds the value it was given."""
    assert getattr(EngineConfig(**{field: value}), field) == value


@pytest.mark.parametrize("kw", [dict(n=2, temperature=1.0), dict(beam_width=2),
                                dict(grammar=object())])
def test_unported_generation_params_raise(kw):
    """Best-of-n, beam search and grammars are ported: the fields construct,
    and a request occupies one batch slot a branch."""
    assert GenerationParams(**kw).n_branches == (1 if "grammar" in kw else 2)


def test_submit_rejects_prompt_larger_than_pool(setup):
    cfg, model, params, _, _, _ = setup
    eng = ServeEngine(model, params, EngineConfig(num_pages=4, page_size=4, max_batch=2,
                                                  max_pages_per_seq=16), device="cpu")
    with pytest.raises(ValueError, match="usable pages"):
        eng.submit(Request(rid=0, prompt=list(range(1, 40)),
                           params=GenerationParams(max_new_tokens=2)))


def test_grown_context_fails_request_and_serves_the_rest(setup):
    """A request whose context grows past the whole pool is failed with
    ``.error`` set; the engine keeps serving everything else."""
    cfg, model, params, _, _, _ = setup
    eng = ServeEngine(model, params, EngineConfig(num_pages=6, page_size=4, max_batch=2,
                                                  max_pages_per_seq=8), device="cpu")
    ok = Request(rid=0, prompt=[5, 6, 7], params=GenerationParams(max_new_tokens=3))
    doomed = Request(rid=1, prompt=list(range(1, 19)), params=GenerationParams(max_new_tokens=8))
    eng.submit_all([ok, doomed])
    eng._pending[1].generated.extend([9, 9, 9])  # the state a preemption would leave
    results = eng.run()
    assert results[0].error is None and len(results[0].generated) == 3
    assert results[1].error is not None and "pool" in results[1].error
    assert results[1].finish_reason == "error" and eng.metrics()["failed"] == 1
