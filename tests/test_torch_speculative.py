"""repro_torch's speculative decoding vs the JAX reference.

The port's n-gram proposer (keys, rebuild, propose, update), its
``ops.verify_draft_tokens`` and its engine windows are held against
``repro.serving.speculative``, ``repro.kernels.ops.verify_draft_tokens`` and
the reference ServeEngine on the same numpy inputs and bridged weights
(qwen2-0.5b smoke width, f32): keys, rows and drafts bit-equal, verify tokens
and committed counts exact (chosen log-probs within 2e-5), engine streams
token-exact, greedy and sampled, over f32 and int8 pages. The scenarios are
the reference's own (tests/test_speculative.py).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.models import build_model as jax_build, get_config as jax_get_config
from repro.serving import GenerationParams as JaxGenerationParams
from repro.serving.engine import (
    EngineConfig as JaxEngineConfig,
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from repro.serving.speculative import NGramProposer as JaxNGramProposer
from repro.serving.speculative import ngram_keys_jnp, ngram_keys_np as jax_ngram_keys_np
from repro_torch.kernels import ops
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from repro_torch.serving.speculative import (
    ModelDraftProposer,
    NGramProposer,
    ngram_keys_np,
    ngram_keys_torch,
)

LP_TOL = 2e-5
SAMPLED = dict(temperature=0.8, top_k=12, top_p=0.95, seed=123)


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    return cfg, (model_j, params_j), (model, params)


def _run_jax(ref, prompts, n, econf, **gen):
    model_j, params_j = ref
    eng = JaxServeEngine(model_j, params_j, JaxEngineConfig(**econf))
    res = eng.run([JaxRequest(rid=i, prompt=list(p),
                              params=JaxGenerationParams(max_new_tokens=n, **gen))
                   for i, p in enumerate(prompts)])
    return {i: list(res[i].generated) for i in res}, eng.metrics()


def _run(port, prompts, n, econf, **gen):
    model, params = port
    eng = ServeEngine(model, params, EngineConfig(**econf), device="cpu")
    res = eng.run([Request(rid=i, prompt=list(p), params=GenerationParams(max_new_tokens=n, **gen))
                   for i, p in enumerate(prompts)])
    return {i: list(res[i].generated) for i in res}, eng


# =====================================================================================
# the n-gram proposer: keys, rebuild, propose, update
# =====================================================================================
@pytest.mark.parametrize("table_size", [2, 64, 512, 4096])
@pytest.mark.parametrize("g", [2, 3, 4])
def test_ngram_keys_host_and_device_bit_equal_to_reference(table_size, g):
    rng = np.random.default_rng(table_size + g)
    grams = rng.integers(0, 2**31 - 1, size=(257, g)).astype(np.int32)
    grams[:5] = rng.integers(0, 512, size=(5, g))
    want = jax_ngram_keys_np(grams, table_size)
    np.testing.assert_array_equal(ngram_keys_np(grams, table_size), want)
    got = ngram_keys_torch(torch.from_numpy(grams), table_size)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(np.asarray(ngram_keys_jnp(jnp.asarray(grams), table_size)),
                                  want)


def _context(rng, n, vocab=40):
    """A token context with repeats, so grams recur and drafts hit."""
    base = rng.integers(0, vocab, size=max(3, n // 3)).tolist()
    return (base * 4)[:n]


@pytest.mark.parametrize("ngram", [2, 3])
@pytest.mark.parametrize("n", [1, 2, 3, 7, 30])
def test_rebuild_row_equals_reference(ngram, n):
    rng = np.random.default_rng(n * 10 + ngram)
    ctx = _context(rng, n)
    kw = dict(spec_tokens=3, ngram=ngram, table_size=64, vocab=512, hist_len=48)
    h, t = NGramProposer(**kw).rebuild_row(ctx)
    hj, tj = JaxNGramProposer(**kw).rebuild_row(ctx)
    np.testing.assert_array_equal(h, hj)
    np.testing.assert_array_equal(t, tj)


@pytest.mark.parametrize("seed", range(4))
def test_rebuild_row_equals_incremental_updates(seed):
    """Windows folded in on the device (random commits, rejected tails left
    in hist) give the table a rebuild from the committed context gives."""
    rng = np.random.default_rng(seed)
    prop = NGramProposer(spec_tokens=3, ngram=2, table_size=32, vocab=40, hist_len=80)
    c = prop.spec_tokens + 1
    ctx = _context(rng, 9)
    h, t = prop.rebuild_row(ctx)
    hist, table = torch.from_numpy(h[None].copy()), torch.from_numpy(t[None].copy())
    one = torch.ones(1, dtype=torch.int32)
    for _ in range(12):
        toks = rng.integers(0, 40, size=(1, c)).astype(np.int32)
        a = int(rng.integers(1, c + 1))
        lens = torch.tensor([len(ctx) - 1], dtype=torch.int32)
        hist, table = prop.update(hist, table, lens, torch.from_numpy(toks),
                                  torch.tensor([a], dtype=torch.int32), one)
        ctx = ctx + toks[0, :a].tolist()
        h, t = prop.rebuild_row(ctx)
        np.testing.assert_array_equal(hist[0, :len(ctx)].numpy(), h[:len(ctx)])
        # the last column is the dump slot of masked writes
        np.testing.assert_array_equal(table[0, :-1].numpy(), t[:-1])


def _batch_state(rng, prop, b=5):
    ctxs = [_context(rng, int(n)) for n in rng.integers(1, 30, size=b)]
    rows = [prop.rebuild_row(ctx) for ctx in ctxs]
    hist = np.stack([h for h, _ in rows])
    table = np.stack([t for _, t in rows])
    lens = np.array([len(ctx) - 1 for ctx in ctxs], np.int32)
    active = np.ones(b, np.int32)
    active[1] = 0
    return hist, table, lens, active


@pytest.mark.parametrize("seed", range(4))
def test_propose_equals_reference(seed):
    rng = np.random.default_rng(100 + seed)
    kw = dict(spec_tokens=4, ngram=2 + seed % 2, table_size=64, vocab=40, hist_len=48)
    prop, prop_j = NGramProposer(**kw), JaxNGramProposer(**kw)
    hist, table, lens, active = _batch_state(rng, prop)
    got = prop.propose(torch.from_numpy(hist), torch.from_numpy(table),
                       torch.from_numpy(lens), torch.from_numpy(active))
    want = prop_j.propose(jnp.asarray(hist), jnp.asarray(table), jnp.asarray(lens),
                          jnp.asarray(active))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[active > 0] != 0).any()  # some rows draft from their history


@pytest.mark.parametrize("seed", range(3))
def test_update_equals_reference(seed):
    """hist and table after one window, inactive rows (the clamped tail
    write) included, bit-equal to the reference's."""
    rng = np.random.default_rng(200 + seed)
    kw = dict(spec_tokens=3, ngram=2, table_size=64, vocab=40, hist_len=48)
    prop, prop_j = NGramProposer(**kw), JaxNGramProposer(**kw)
    hist, table, lens, active = _batch_state(rng, prop)
    toks = rng.integers(0, 40, size=(len(lens), 4)).astype(np.int32)
    committed = rng.integers(0, 5, size=len(lens)).astype(np.int32)
    gh, gt = prop.update(torch.from_numpy(hist.copy()), torch.from_numpy(table.copy()),
                         torch.from_numpy(lens), torch.from_numpy(toks),
                         torch.from_numpy(committed), torch.from_numpy(active))
    wh, wt = prop_j.update(jnp.asarray(hist), jnp.asarray(table), jnp.asarray(lens),
                           jnp.asarray(toks), jnp.asarray(committed), jnp.asarray(active))
    np.testing.assert_array_equal(gh.numpy(), np.asarray(wh))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(wt))


def test_proposer_validation_and_model_draft_stub():
    with pytest.raises(ValueError, match="spec_ngram"):
        NGramProposer(spec_tokens=2, ngram=1, hist_len=8)
    with pytest.raises(ValueError, match="power of two"):
        NGramProposer(spec_tokens=2, table_size=100, hist_len=8)
    with pytest.raises(ValueError, match="hist_len"):
        NGramProposer(spec_tokens=2)
    with pytest.raises(NotImplementedError, match="NGramProposer"):
        ModelDraftProposer(spec_tokens=2).rebuild_row([1, 2])


# =====================================================================================
# the PRNG draws and verify_draft_tokens
# =====================================================================================
def test_scalar_uniform_and_tagged_gumbel_bit_equal_to_jax():
    rng = np.random.default_rng(7)
    seeds = rng.integers(0, 2**32, size=48, dtype=np.uint64).astype(np.uint32)
    pos = rng.integers(0, 1 << 20, size=48).astype(np.int32)

    def ref(s, p):
        base = jax.random.fold_in(jax.random.PRNGKey(s), p)
        return (jax.random.uniform(jax.random.fold_in(base, jops.SPEC_ACCEPT_FOLD)),
                jax.random.gumbel(jax.random.fold_in(base, jops.SPEC_RESAMPLE_FOLD), (67,)))

    u_j, g_j = jax.vmap(ref)(jnp.asarray(seeds), jnp.asarray(pos))
    assert (ops.SPEC_ACCEPT_FOLD, ops.SPEC_RESAMPLE_FOLD) == (jops.SPEC_ACCEPT_FOLD,
                                                              jops.SPEC_RESAMPLE_FOLD)
    k0, k1 = ops.position_keys(torch.from_numpy(seeds.astype(np.int64)), torch.from_numpy(pos))
    u = ops.uniform_from_key(*ops.fold_in(k0, k1, ops.SPEC_ACCEPT_FOLD))
    g = ops.gumbel_from_key(*ops.fold_in(k0, k1, ops.SPEC_RESAMPLE_FOLD), 67)
    np.testing.assert_array_equal(u.numpy().view(np.int32), np.asarray(u_j).view(np.int32))
    np.testing.assert_array_equal(g.numpy().view(np.int32), np.asarray(g_j).view(np.int32))


def _verify_inputs(seed, b=6, k=4, vocab=50, vp=64, temps=(0.0,)):
    rng = np.random.default_rng(seed)
    c = k + 1
    logits = (rng.standard_normal((b, c, vp)) * 3).astype(np.float32)
    greedy = logits[..., :vocab].argmax(-1)
    draft = greedy[:, :k].copy()
    for i in range(b):  # row i agrees on its first i % c draft tokens
        j = i % c
        if j < k:
            draft[i, j] = (draft[i, j] + 1 + rng.integers(0, vocab - 1)) % vocab
    draft[-1, -1] = vocab + 7  # a garbage proposal is clipped, then rejected
    temp = np.array([temps[i % len(temps)] for i in range(b)], np.float32)
    top_k = np.array([0, 5, 0, 20, 3, 0][:b], np.int32)
    top_p = np.array([1.0, 0.9, 0.8, 1.0, 1.0, 0.95][:b], np.float32)
    seeds = rng.integers(0, 2**31, size=b).astype(np.int32)
    pos0 = rng.integers(1, 500, size=b).astype(np.int32)
    active = np.ones(b, np.int32)
    active[2] = 0
    return (logits, draft.astype(np.int32), temp, top_k, top_p, seeds, pos0, active), vocab


@pytest.mark.parametrize("temps", [(0.0,), (0.7, 1.0, 1.3), (0.0, 0.9)],
                         ids=["greedy", "sampled", "mixed"])
@pytest.mark.parametrize("seed", range(3))
def test_verify_draft_tokens_equals_reference(temps, seed):
    arrays, vocab = _verify_inputs(seed, temps=temps)
    tw, cw, lw = jops.verify_draft_tokens(*[jnp.asarray(a) for a in arrays[:5]],
                                          jnp.asarray(arrays[5]).astype(jnp.uint32),
                                          *[jnp.asarray(a) for a in arrays[6:]], vocab=vocab)
    sampled = any(t > 0 for t in temps)
    for hint in (sampled, None):
        tg, cg, lg = ops.verify_draft_tokens(*[torch.from_numpy(a) for a in arrays],
                                             vocab=vocab, sampled=hint)
        np.testing.assert_array_equal(tg.numpy(), np.asarray(tw))
        np.testing.assert_array_equal(cg.numpy(), np.asarray(cw))
        np.testing.assert_allclose(lg.numpy(), np.asarray(lw), rtol=LP_TOL, atol=LP_TOL)
    committed = cg.numpy()
    assert committed[2] == 0 and (committed[arrays[7] > 0] >= 1).all()
    if not sampled:  # greedy: row i accepts exactly its agreeing prefix
        assert [int(x) for x in committed] == [1, 2, 0, 4, 5, 1]


# =====================================================================================
# the engine: token-exact against the JAX spec engine and the port's plain one
# =====================================================================================
def _spec_prompts(vocab, seed=10):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, size=4).tolist() * 3)[:10] for _ in range(2)]


BASE = dict(num_pages=64, page_size=8, max_batch=2, max_pages_per_seq=8)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
@pytest.mark.parametrize("windows", [1, 2])
def test_engine_spec_greedy_token_exact(models, kv_dtype, windows):
    cfg, ref, port = models
    prompts = _spec_prompts(cfg.vocab)
    econf = dict(BASE, kv_dtype=kv_dtype)
    spec = dict(econf, spec_tokens=3, multi_step=windows, spec_backoff=0)
    want, m_ref = _run_jax(ref, prompts, 20, spec)
    got, eng = _run(port, prompts, 20, spec)
    plain, _ = _run(port, prompts, 20, econf)
    assert got == want == plain
    m = eng.metrics()
    assert m["spec_windows"] > 0 and m["accepted_tokens_per_step"] >= 1.0
    for key in ("spec_windows", "spec_accepted_tokens", "spec_rollback_tokens",
                "decode_steps", "fused_steps"):
        assert m[key] == m_ref[key], key


def test_engine_spec_sampled_stream_equals_reference(models):
    cfg, ref, port = models
    prompts = [np.random.default_rng(11).integers(0, cfg.vocab, size=8).tolist()
               for _ in range(2)]
    econf = dict(BASE, spec_tokens=3, multi_step=2, spec_backoff=0)
    want, _ = _run_jax(ref, prompts, 12, econf, **SAMPLED)
    got, eng = _run(port, prompts, 12, econf, **SAMPLED)
    assert got == want
    assert eng.metrics()["spec_windows"] > 0
    again, _ = _run(port, prompts, 12, econf, **SAMPLED)
    other, _ = _run(port, prompts, 12, econf, **dict(SAMPLED, seed=124))
    assert again == got and other != got


def test_engine_spec_eos_in_draft_truncates_exact(models):
    cfg, ref, port = models
    rng = np.random.default_rng(12)
    prompts = [rng.integers(0, cfg.vocab, size=8).tolist() for _ in range(2)]
    probe, _ = _run(port, prompts, 16, BASE)
    eos = probe[0][5]  # an id the greedy stream reaches mid-sequence
    plain, _ = _run(port, prompts, 16, BASE, eos_id=eos)
    got, eng = _run(port, prompts, 16, dict(BASE, spec_tokens=3, multi_step=2,
                                            spec_backoff=0), eos_id=eos)
    assert plain[0][-1] == eos and len(plain[0]) <= 16
    assert got == plain
    assert eng.results[0].finish_reason == "eos"
    assert eng.cache.num_free == eng.cache.num_pages - 1


def test_engine_spec_preemption_between_windows(models):
    cfg, ref, port = models
    rng = np.random.default_rng(13)
    prompts = [rng.integers(0, cfg.vocab, size=8).tolist() for _ in range(3)]
    big, _ = _run(port, prompts, 10, dict(num_pages=64, page_size=4, max_batch=3,
                                          max_pages_per_seq=8))
    got, eng = _run(port, prompts, 10, dict(num_pages=12, page_size=4, max_batch=3,
                                            max_pages_per_seq=6, spec_tokens=2,
                                            spec_backoff=0))
    m = eng.metrics()
    assert m["preemptions"] >= 1 and m["spec_windows"] > 0
    assert got == big


def test_engine_spec_device_mirrors_equal_host_after_rollbacks(models):
    """After every speculative dispatch the proposer's device rows of each
    live slot equal a host rebuild from its context, and at quiescence the
    device tables and lens equal the host allocator's."""
    cfg, ref, port = models
    model, params = port
    rng = np.random.default_rng(14)
    prompts = [rng.integers(0, cfg.vocab, size=8).tolist() for _ in range(2)]
    eng = ServeEngine(model, params, EngineConfig(
        num_pages=48, page_size=4, max_batch=2, max_pages_per_seq=8, spec_tokens=3,
        multi_step=2, spec_backoff=0), device="cpu")
    spec_once, checked = eng._decode_spec_once, []

    def spec_then_check(decoding, s):
        spec_once(decoding, s)
        _, lens_dev = eng.cache.device_state()
        for slot, st in decoding.items():
            if st.done:
                continue
            h, t = eng._proposer.rebuild_row(st.context)
            n = len(st.context)
            np.testing.assert_array_equal(eng._hist_dev[slot, :n].numpy(), h[:n])
            np.testing.assert_array_equal(eng._table_dev[slot, :-1].numpy(), t[:-1])
            assert int(lens_dev[slot]) == eng.cache.lens[slot] == n - 1
            checked.append(slot)

    eng._decode_spec_once = spec_then_check
    eng.run([Request(rid=i, prompt=p, params=GenerationParams(max_new_tokens=12))
             for i, p in enumerate(prompts)])
    assert checked and eng.metrics()["spec_rollback_tokens"] > 0
    tables_dev, lens_dev = eng.cache.device_state()
    np.testing.assert_array_equal(tables_dev.numpy(), eng.cache.tables)
    np.testing.assert_array_equal(lens_dev.numpy(), eng.cache.lens)


def test_engine_spec_opt_out_and_validation(models):
    cfg, ref, port = models
    model, params = port
    prompts = [np.random.default_rng(15).integers(0, cfg.vocab, size=8).tolist()]
    conf = dict(num_pages=32, page_size=8, max_batch=1, max_pages_per_seq=4, spec_tokens=3)
    got, eng = _run(port, prompts, 8, conf, speculative=False)
    assert eng.metrics()["spec_windows"] == 0
    base, plain = _run(port, prompts, 8, dict(conf, spec_tokens=0))
    assert got == base
    assert "spec_windows" not in plain.metrics()  # absent when speculation is off
    with pytest.raises(ValueError, match="spec_tokens"):
        plain.submit(prompts[0], GenerationParams(speculative=True))
    with pytest.raises(ValueError, match="record_logits"):
        EngineConfig(**conf, record_logits=True)
    assert GenerationParams(speculative=True).speculative


def test_engine_spec_predictable_stream_metrics_equal_reference(models):
    """Every parameter zeroed but the embedding: the logits are uniformly
    zero, the greedy stream is constant and nearly every draft hits."""
    cfg, ref, port = models
    model_j, params_j = ref
    zp_j = dict(jax.tree.map(jnp.zeros_like, params_j), embed=params_j["embed"])
    zp = from_jax_params(jax.tree.map(np.asarray, zp_j), cfg, device="cpu")
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6]]
    econf = dict(num_pages=64, page_size=8, max_batch=1, max_pages_per_seq=8)
    spec = dict(econf, spec_tokens=3, multi_step=2)
    want, m_ref = _run_jax((model_j, zp_j), prompts, 32, spec)
    got, eng = _run((port[0], zp), prompts, 32, spec)
    plain, _ = _run((port[0], zp), prompts, 32, econf)
    assert got == want == plain
    m = eng.metrics()
    assert m["accepted_tokens_per_step"] > 1.5 and m["draft_hit_rate"] > 0.5
    for key in ("spec_windows", "spec_accepted_tokens", "accepted_tokens_per_step",
                "draft_hit_rate", "spec_rollback_tokens", "spec_backoffs", "decode_steps",
                "fused_steps"):
        assert m[key] == m_ref[key], key
