"""repro_torch's fused K-step decode and top-k logprobs vs the JAX reference.

``EngineConfig(multi_step=K)`` runs K decode steps a dispatch
(``serving.step.make_paged_serve_multistep``: a host loop with no
device-to-host transfer inside it); its streams are held token for token
against the reference engine at the same K (a ``lax.scan``), greedy and
sampled, on bridged qwen2-0.5b smoke weights in f32. The scheduler's
horizon proofs (``event_free_horizon``, ``reserve_decode_tokens``) are held
against the reference scheduler on the same states, and the top-k logprob
pair (``logprobs_k``) against the reference's ids and values.
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
from repro.serving.engine.cache import PagedKVCache as JaxPagedKVCache
from repro.serving.engine.request import (
    RequestQueue as JaxRequestQueue,
    RequestState as JaxRequestState,
)
from repro.serving.engine.scheduler import (
    Scheduler as JaxScheduler,
    SchedulerConfig as JaxSchedulerConfig,
)
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams
from repro_torch.serving.engine import (
    EngineConfig,
    PagedKVCache,
    Request,
    RequestQueue,
    RequestState,
    Scheduler,
    SchedulerConfig,
    ServeEngine,
)
from repro_torch.serving.step import top_logprobs

SAMPLED = dict(temperature=0.9, top_k=20, top_p=0.95, seed=11)
ECONF = dict(num_pages=40, page_size=4, max_batch=4, max_pages_per_seq=10)
LP_TOL = 1e-5


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (5, 9, 16, 3, 12)]
    return cfg, (model_j, params_j), (model, params), prompts


def _run_jax(ref, prompts, n, econf, **gen):
    model_j, params_j = ref
    eng = JaxServeEngine(model_j, params_j, JaxEngineConfig(**econf))
    res = eng.run([JaxRequest(rid=i, prompt=list(p),
                              params=JaxGenerationParams(max_new_tokens=n, **gen))
                   for i, p in enumerate(prompts)])
    return res, eng.metrics()


def _run(port, prompts, n, econf, **gen):
    model, params = port
    eng = ServeEngine(model, params, EngineConfig(**econf), device="cpu")
    res = eng.run([Request(rid=i, prompt=list(p), params=GenerationParams(max_new_tokens=n, **gen))
                   for i, p in enumerate(prompts)])
    return res, eng


def _tokens(res):
    return {i: list(res[i].generated) for i in res}


@pytest.mark.parametrize("sampling", [{}, SAMPLED], ids=["greedy", "sampled"])
@pytest.mark.parametrize("k", [1, 2, 4])
def test_multistep_tokens_equal_reference(models, k, sampling):
    cfg, ref, port, prompts = models
    econf = dict(ECONF, multi_step=k)
    want, m_ref = _run_jax(ref, prompts, 10, econf, **sampling)
    got, eng = _run(port, prompts, 10, econf, **sampling)
    assert _tokens(got) == _tokens(want)
    m = eng.metrics()
    assert m["fused_steps"] == m_ref["fused_steps"]
    assert m["decode_steps"] == m_ref["decode_steps"]
    assert (m["fused_steps"] > 0) == (k > 1)
    if k > 1:  # token-exact against the single step too
        single, _ = _run(port, prompts, 10, ECONF, **sampling)
        assert _tokens(got) == _tokens(single)


def test_multistep_eos_mid_window(models):
    cfg, ref, port, prompts = models
    probe, _ = _run(port, prompts, 12, ECONF)
    eos = probe[0].generated[5]
    single, _ = _run(port, prompts, 12, ECONF, eos_id=eos)
    fused, eng = _run(port, prompts, 12, dict(ECONF, multi_step=4), eos_id=eos)
    assert single[0].generated[-1] == eos and single[0].finish_reason == "eos"
    assert _tokens(fused) == _tokens(single)
    assert fused[0].finish_reason == "eos" and eng.metrics()["fused_steps"] > 0
    assert eng.cache.num_free == eng.cache.num_pages - 1


# ---------------------------------------------------------------------------------
# the scheduler's horizon proofs on the same states as the reference's
# ---------------------------------------------------------------------------------
def _schedulers(models):
    cfg, (model_j, _), (model, _), _ = models
    kw = dict(num_pages=16, page_size=4, max_batch=3, max_pages_per_seq=6)
    mine = Scheduler(PagedKVCache(model, **kw), SchedulerConfig(3, 1))
    ref = JaxScheduler(JaxPagedKVCache(model_j, **kw), JaxSchedulerConfig(3, 1))
    return mine, ref


def _admit(sched, queue_cls, state_cls, req_cls, params_cls, prompt, n_new, generated, length):
    queue = queue_cls()
    st = state_cls(req_cls(len(sched.running), prompt, params_cls(max_new_tokens=n_new)))
    queue.push(st)
    sched.admit(queue, 0.0)
    st.generated.extend(generated)
    sched.cache.set_len(st.slot, length)
    return st


STATES = [  # (prompt, max_new_tokens, generated, resident length)
    ([1, 2, 3, 4, 5, 6, 7], 12, [1], 8),   # exactly on an owned-page boundary
    ([9, 8, 7], 20, [4, 5], 4),
    ([2] * 10, 6, [3, 3, 3], 12),
]


def test_event_free_horizon_and_reserve_equal_reference(models):
    mine, ref = _schedulers(models)
    for prompt, n_new, gen, length in STATES:
        _admit(mine, RequestQueue, RequestState, Request, GenerationParams, prompt, n_new,
               gen, length)
        _admit(ref, JaxRequestQueue, JaxRequestState, JaxRequest, JaxGenerationParams,
               prompt, n_new, gen, length)
    q_mine, q_ref = RequestQueue(), JaxRequestQueue()

    def same():
        for tps in range(1, 7):
            assert (mine.event_free_horizon(q_mine, tokens_per_step=tps)
                    == ref.event_free_horizon(q_ref, tokens_per_step=tps)), tps
        for slot in mine.running:
            assert mine.cache.capacity_tokens(slot) == ref.cache.capacity_tokens(slot)
            assert mine.cache.pages_of[slot] == ref.cache.pages_of[slot]
        assert mine.cache.num_free == ref.cache.num_free

    same()
    assert mine.event_free_horizon(q_mine) == 0  # slot 0 sits on its page boundary
    for n in (1, 4, 5, 12, 100):
        for slot in list(mine.running):
            assert (mine.reserve_decode_tokens(slot, n)
                    == ref.reserve_decode_tokens(slot, n)), (slot, n)
        same()
    assert mine.event_free_horizon(q_mine) > 0
    # a queued request or a prefilling slot leaves no horizon
    q_mine.push(RequestState(Request(9, [1, 2], GenerationParams())))
    assert mine.event_free_horizon(q_mine) == 0
    q_mine.pop()
    next(iter(mine.running.values())).chunk_cursor = 0
    assert mine.event_free_horizon(q_mine) == 0


# ---------------------------------------------------------------------------------
# top-k logprobs
# ---------------------------------------------------------------------------------
def test_top_logprobs_orders_ties_lower_id_first():
    logits = torch.tensor([[0.5, 2.0, 2.0, -1.0, 2.0, 9.9],
                           [0.0, 0.0, 0.0, 0.0, 0.0, 0.0]])
    vals, ids = top_logprobs(logits, vocab=5, k=4)  # column 5 is padding
    assert ids.tolist() == [[1, 2, 4, 0], [0, 1, 2, 3]]
    assert torch.equal(vals[0, :3], vals[0, :1].expand(3))
    want = torch.log_softmax(logits[:, :5], dim=-1)
    assert torch.equal(vals, want.gather(1, ids.long()))


@pytest.mark.parametrize("sampling", [{}, SAMPLED], ids=["greedy", "sampled"])
def test_logprobs_equal_reference(models, sampling):
    """Every generated token's top-k pairs (the prefill's first token, single
    steps and fused windows alike): ids equal, values within 1e-5."""
    cfg, ref, port, prompts = models
    econf = dict(ECONF, multi_step=2, logprobs_k=4)
    want, _ = _run_jax(ref, prompts, 8, econf, logprobs=3, **sampling)
    got, _ = _run(port, prompts, 8, econf, logprobs=3, **sampling)
    assert _tokens(got) == _tokens(want)
    for i in want:
        mine, theirs = got[i].sequences[0].logprobs, want[i].sequences[0].logprobs
        assert sorted(mine) == sorted(theirs) == list(range(8))
        for n in theirs:
            assert [t for t, _ in mine[n]] == [t for t, _ in theirs[n]], (i, n)
            np.testing.assert_allclose([v for _, v in mine[n]], [v for _, v in theirs[n]],
                                       rtol=LP_TOL, atol=LP_TOL)
        assert got[i].sequences[0].cumulative_logprob == pytest.approx(
            want[i].sequences[0].cumulative_logprob, abs=1e-4)


def test_logprobs_identical_across_fused_horizons(models):
    cfg, ref, port, prompts = models
    runs = [_run(port, prompts, 9, dict(ECONF, multi_step=k, logprobs_k=3), logprobs=2)[0]
            for k in (1, 3)]
    assert _tokens(runs[0]) == _tokens(runs[1])
    for i in runs[0]:
        assert runs[0][i].sequences[0].logprobs == runs[1][i].sequences[0].logprobs
        assert len(runs[0][i].sequences[0].logprobs[4]) == 2
    # a request that asks for none gets none, on an engine that computes them
    none, _ = _run(port, prompts[:1], 3, dict(ECONF, logprobs_k=3))
    assert none[0].sequences[0].logprobs == {}


def test_logprobs_wider_than_engine_rejected(models):
    cfg, ref, port, prompts = models
    model, params = port
    eng = ServeEngine(model, params, EngineConfig(**ECONF, logprobs_k=2), device="cpu")
    with pytest.raises(ValueError, match="logprobs_k"):
        eng.submit(prompts[0], GenerationParams(logprobs=3))
    plain = ServeEngine(model, params, EngineConfig(**ECONF), device="cpu")
    with pytest.raises(ValueError, match="logprobs_k"):
        plain.submit(prompts[0], GenerationParams(logprobs=1))
    eng.submit(prompts[0], GenerationParams(logprobs=2))


def test_fused_window_trace_events_sum_to_fused_steps(models):
    cfg, ref, port, prompts = models
    _, eng = _run(port, prompts, 10, dict(ECONF, multi_step=4, trace=True))
    windows = [ev for ev in eng.trace.events if ev.name == "fused_window" and ev.ph == "B"]
    m = eng.metrics()
    assert windows and sum(ev.args["k"] for ev in windows) == m["fused_steps"] > 0
    singles = eng.trace.count("decode", "B")
    assert singles + m["fused_steps"] == m["decode_steps"]
