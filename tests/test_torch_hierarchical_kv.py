"""repro_torch's host KV tier (cache.TierManager) vs the JAX reference.

The tier's laws (the host prefix match, LRU and deadline eviction, the
per-step budget, release) are held against the reference's TierManager on
the same operations; the engine with a tier in a pool tight enough to
preempt gives the JAX engine's tokens AND its tier counters on bridged
qwen2-0.5b smoke weights in f32, page 4; int4 pages (packed bytes and
scales) round-trip bit for bit; a starved tier falls back to recompute; a
rejected request leaves no host residency; and a promoted shared page is
copied on write.
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
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams
from repro_torch.serving.engine import EngineConfig, PagedKVCache, Request, ServeEngine
from repro_torch.serving.engine.kvquant import pool_leaves
from repro_torch.serving.engine.request import page_hash_chain

TIER_KEYS = ("preemptions", "swap_out_pages", "swap_out_elided", "swap_in_pages",
             "prefetch_hits", "evictions", "host_pages_resident", "cow_copies",
             "prefill_tokens_computed", "prefill_tokens_skipped")


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    return cfg, (model_j, params_j), (model, params)


def _reqs(cls, params_cls, prompts, n_gen, first=0):
    return [cls(rid=first + i, prompt=list(p), params=params_cls(max_new_tokens=n_gen))
            for i, p in enumerate(prompts)]


def _both(models, conf, runs):
    """Run the same sequence of ``runs`` [(prompts, n_gen, first rid)] on one
    JAX and one port engine; tokens equal run by run. Returns (jax engine,
    port engine, jax metrics, port metrics) of the last run."""
    cfg, (model_j, params_j), (model, params) = models
    eng_j = JaxServeEngine(model_j, params_j, JaxEngineConfig(**conf))
    eng = ServeEngine(model, params, EngineConfig(**conf), device="cpu")
    for prompts, n_gen, first in runs:
        want = eng_j.run(_reqs(JaxRequest, JaxGenerationParams, prompts, n_gen, first))
        got = eng.run(_reqs(Request, GenerationParams, prompts, n_gen, first))
        assert sorted(got) == sorted(want)
        for rid in want:
            assert got[rid].generated == want[rid].generated, rid
    return eng_j, eng, eng_j.metrics(), eng.metrics()


def _prompts(cfg, seed, sizes):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab, size=n).tolist() for n in sizes]


# ---------------------------------------------------------------------------------
# TierManager laws vs the reference's
# ---------------------------------------------------------------------------------
def _caches(models, host_pages=4, budget=0):
    cfg, (model_j, _), (model, _) = models
    kw = dict(num_pages=24, page_size=4, max_batch=4, max_pages_per_seq=8,
              host_pool_pages=host_pages, swap_budget_pages_per_step=budget)
    return PagedKVCache(model, **kw), JaxPagedKVCache(model_j, **kw)


def _tier_state(c):
    t = c.tier
    return (dict(t._index), sorted(t._free), dict(t._touch), sorted(t._expiry),
            t.swap_out_pages, t.swap_out_elided, t.swap_in_pages, t.prefetch_hits, t.evictions,
            t.budget_left)


def _fill(c, slot, tokens):
    chain = page_hash_chain(tokens, c.page_size)
    c.allocate(slot, c.pages_for(len(tokens) + 1), tokens=tokens, chain=chain)
    c.set_len(slot, len(tokens))
    return chain


TIER_OPS = {
    # demote three sessions through a 4-page tier: LRU evicts the oldest
    "lru": [("fill", 0, 8), ("demote", 0), ("free", 0), ("fill", 1, 8), ("demote", 1),
            ("free", 1), ("fill", 2, 8), ("demote", 2), ("free", 2), ("fill", 0, 8),
            ("free", 0)],
    # a re-demotion of resident keys is elided; a promotion touches them
    "elide_and_promote": [("fill", 0, 12), ("demote", 0), ("free", 0), ("fill", 1, 12),
                          ("demote", 1), ("free", 1), ("fill", 2, 12), ("free", 2)],
    # budget 2 pages a step truncates a run's tail; begin_step re-arms it
    "budget": [("fill", 0, 16), ("demote", 0), ("free", 0), ("step",), ("fill", 1, 16),
               ("free", 1), ("step",), ("fill", 2, 16), ("free", 2)],
    # deadlines: expired retained pages go before older unexpired ones
    "expiry": [("fill", 0, 8), ("demote_retain", 0, 300.0), ("free", 0), ("fill", 1, 8),
               ("demote_retain", 1, 1e-9), ("free", 1), ("fill", 2, 8), ("demote", 2),
               ("free", 2), ("fill", 3, 8), ("free", 3)],
    "release": [("fill", 0, 12), ("demote", 0), ("free", 0), ("release", 0), ("fill", 1, 12),
                ("free", 1)],
}


@pytest.mark.parametrize("budget", [0, 2])
@pytest.mark.parametrize("ops", list(TIER_OPS.values()), ids=list(TIER_OPS))
def test_tier_laws_equal_the_reference(models, ops, budget):
    cfg = models[0]
    mine, ref = _caches(models, budget=budget)
    sessions = {i: np.random.default_rng(40 + i).integers(0, cfg.vocab, 16).tolist()
                for i in range(4)}
    chains, released = {}, []
    for op in ops:
        for c in (mine, ref):
            name, *a = op
            if name == "fill":
                chains[(id(c), a[0])] = _fill(c, a[0], sessions[a[0]][:a[1]])
            elif name == "demote":
                c.demote_slot(a[0], chains[(id(c), a[0])])
            elif name == "demote_retain":
                c.demote_slot(a[0], chains[(id(c), a[0])], retain_s=a[1])
            elif name == "free":
                c.free_slot(a[0])
            elif name == "step":
                c.tier.begin_step()
            elif name == "release":
                released.append(c.release_host(page_hash_chain(sessions[a[0]][:12], 4)))
        assert _tier_state(mine) == _tier_state(ref), op
        assert len(set(released)) <= 1
        np.testing.assert_array_equal(mine.tables, ref.tables)
        np.testing.assert_array_equal(mine.ref, ref.ref)
        mine.check_conservation()
    st_m, st_r = mine.stats(), ref.stats()
    assert {k: st_m[k] for k in st_r} == st_r


def test_tier_match_run_and_host_pools(models):
    cfg = models[0]
    mine, _ = _caches(models, host_pages=8)
    tokens = list(range(3, 19))
    chain = _fill(mine, 0, tokens)
    assert mine.tier._leaves is None  # nothing demoted: no host memory
    assert mine.tier.match_run(chain, 0) == 0
    assert mine.demote_slot(0, chain) == 4
    leaves = mine.tier._leaves
    assert [t.device.type for t in leaves] == ["cpu"] * len(leaves)
    assert [t.dtype for t in leaves] == [t.dtype for t in pool_leaves(mine.pools)]
    assert mine.tier.match_run(chain, 0) == 4 and mine.tier.match_run(chain, 2) == 2
    assert mine.tier.match_run(page_hash_chain([9] + tokens[1:], 4), 0) == 0
    mine.free_slot(0)
    mine.check_conservation()


# ---------------------------------------------------------------------------------
# the engine vs the JAX engine
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("chunked", [False, True], ids=["monolithic", "chunked"])
def test_tight_pool_with_a_tier_equals_the_jax_engine(models, chunked):
    cfg = models[0]
    prompts = _prompts(cfg, 1, (8, 8, 8))
    conf = dict(num_pages=10, page_size=4, max_batch=3, max_pages_per_seq=6, host_pool_pages=32)
    if chunked:
        conf.update(num_pages=9, chunked_prefill=True, chunk_tokens=8)
    _, eng, m_j, m = _both(models, conf, [(prompts, 10, 0)])
    for k in TIER_KEYS:
        assert m[k] == m_j[k], k
    assert m["preemptions"] >= 1 and m["swap_out_pages"] > 0
    assert m["swap_in_pages"] == m["prefetch_hits"] > 0
    # and the tokens equal a tier-less large-pool engine's
    big = ServeEngine(*models[2], EngineConfig(num_pages=64, page_size=4, max_batch=3,
                                                max_pages_per_seq=6), device="cpu")
    ref = big.run(_reqs(Request, GenerationParams, prompts, 10))
    assert [eng.results[i].generated for i in range(3)] == [ref[i].generated for i in range(3)]


def test_retained_sessions_resume_through_the_tier_equal_the_jax_engine(models):
    """Finished sessions retained on the host, resumed by three follow-ups
    that share the context, with preemption mid-flight, run twice: the JAX
    engine's tokens and counters, and the device mirrors equal the host's."""
    cfg = models[0]
    rng = np.random.default_rng(9)
    session = rng.integers(0, cfg.vocab, size=16).tolist()
    follow = [session + rng.integers(0, cfg.vocab, size=k).tolist() for k in (2, 3, 4)]
    conf = dict(num_pages=14, page_size=4, max_batch=3, max_pages_per_seq=8,
                host_pool_pages=32, retain_finished_s=300.0)
    _, eng, m_j, m = _both(models, conf, [([session], 4, 0), (follow, 6, 10)])
    for k in TIER_KEYS:
        assert m[k] == m_j[k], k
    assert m["prefetch_hits"] > 0
    tables, lens = eng.cache.device_state()
    np.testing.assert_array_equal(tables.numpy(), eng.cache.tables)
    np.testing.assert_array_equal(lens.numpy(), eng.cache.lens)


def test_swap_budget_truncates_and_stays_exact(models):
    cfg = models[0]
    prompts = _prompts(cfg, 2, (12, 9, 10))
    conf = dict(num_pages=12, page_size=4, max_batch=3, max_pages_per_seq=8, host_pool_pages=32,
                swap_budget_pages_per_step=1)
    _, _, m_j, m = _both(models, conf, [(prompts, 12, 0)])
    for k in TIER_KEYS:
        assert m[k] == m_j[k], k
    assert m["preemptions"] >= 1


def test_zero_host_headroom_falls_back_to_recompute(models):
    cfg = models[0]
    prompts = _prompts(cfg, 1, (8, 8, 8))
    conf = dict(num_pages=10, page_size=4, max_batch=3, max_pages_per_seq=6, host_pool_pages=1)
    _, eng, m_j, m = _both(models, conf, [(prompts, 10, 0)])
    for k in TIER_KEYS:
        assert m[k] == m_j[k], k
    assert m["preemptions"] >= 1 and m["host_pages_resident"] <= 1
    plain = ServeEngine(*models[2], EngineConfig(num_pages=10, page_size=4, max_batch=3,
                                                  max_pages_per_seq=6), device="cpu")
    ref = plain.run(_reqs(Request, GenerationParams, prompts, 10))
    assert [eng.results[i].generated for i in range(3)] == [ref[i].generated for i in range(3)]


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_pages_round_trip_bit_identical(models, kv_dtype):
    """Demote -> free -> wipe -> promote preserves every stored byte of an
    intN page, the packed q and the per-(page, head) scales."""
    cfg, _, (model, params) = models
    eng = ServeEngine(model, params, EngineConfig(num_pages=16, page_size=4, max_batch=2,
                                                  max_pages_per_seq=6, kv_dtype=kv_dtype,
                                                  host_pool_pages=8), device="cpu")
    cache = eng.cache
    tokens = np.random.default_rng(3).integers(0, cfg.vocab, size=12).tolist()
    chain = page_hash_chain(tokens, cache.page_size)
    pages = cache.allocate(0, 4, tokens=tokens)
    g = torch.Generator().manual_seed(3)
    for leaf in pool_leaves(cache.pools):
        fill = torch.randint(0, 100, leaf[:, pages].shape, generator=g)
        leaf[:, pages] = fill.to(leaf.dtype)
    snapshot = [leaf[:, pages[:3]].clone() for leaf in pool_leaves(cache.pools)]
    cache.set_len(0, 12)
    assert cache.demote_slot(0, chain) == 3  # complete pages only
    cache.free_slot(0)
    for leaf in pool_leaves(cache.pools):
        leaf[:, pages[:3]] = 0  # only the tier can give the bytes back
    new_pages = cache.allocate(1, 4, tokens=tokens, chain=chain)
    assert cache.tier.prefetch_hits == 3 and cache.adopted_pages(1) == 3
    for leaf, snap in zip(pool_leaves(cache.pools), snapshot):
        assert torch.equal(leaf[:, new_pages[:3]], snap)
    cache.free_slot(1)
    cache.check_conservation()


def test_reject_impossible_releases_host_residency(models):
    cfg, _, (model, params) = models
    rng = np.random.default_rng(11)
    session = rng.integers(0, cfg.vocab, size=12).tolist()
    eng = ServeEngine(model, params, EngineConfig(num_pages=8, page_size=4, max_batch=2,
                                                  max_pages_per_seq=11, host_pool_pages=16,
                                                  retain_finished_s=300.0), device="cpu")
    eng.run(_reqs(Request, GenerationParams, [session], 3))
    assert eng.metrics()["host_pages_resident"] >= 3
    doomed = session + rng.integers(0, cfg.vocab, size=12).tolist()  # 24 tokens
    eng.submit(Request(rid=99, prompt=doomed, params=GenerationParams(max_new_tokens=16)))
    # the context grew while requeued (as after preemptions) past the pool
    eng._pending[0].generated.extend(int(t) for t in rng.integers(0, cfg.vocab, size=8))
    res = eng.run()
    assert res[99].error is not None and res[99].finish_reason == "error"
    assert len(res[99].generated) == 8
    assert eng.metrics()["host_pages_resident"] == 0
    eng.cache.check_conservation()


def test_cow_on_a_promoted_shared_page(models):
    """Two resumers of one retained session (an unaligned extension) share
    the promoted pages and a partial page, so their first decode appends copy
    on write; a third resume after the churn still hits the tier. Tokens and
    counters equal the JAX engine's, and an engine with no tier."""
    cfg = models[0]
    session = np.random.default_rng(5).integers(0, cfg.vocab, size=12).tolist()
    ext = session + [7, 8]
    conf = dict(num_pages=48, page_size=4, max_batch=3, max_pages_per_seq=8,
                host_pool_pages=32, retain_finished_s=300.0)
    _, eng, m_j, m = _both(models, conf, [([session], 3, 0), ([ext, ext], 5, 10)])
    for k in TIER_KEYS:
        assert m[k] == m_j[k], k
    assert m["prefetch_hits"] >= 3 and m["cow_copies"] >= 1
    assert eng.results[10].generated == eng.results[11].generated
    again = eng.run(_reqs(Request, GenerationParams, [ext], 5, 12))
    oracle = ServeEngine(*models[2], EngineConfig(num_pages=48, page_size=4, max_batch=3,
                                                   max_pages_per_seq=8), device="cpu")
    want = oracle.run(_reqs(Request, GenerationParams, [ext], 5, 10))[10].generated
    assert again[12].generated == eng.results[10].generated == want
