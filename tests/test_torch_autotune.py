"""repro_torch's kernel autotuner and decode block-shape knob, held to the
reference's laws (tests/test_autotune.py, ported test for test) and against
the JAX package itself.

Knob semantics: ``effective_block_pages`` snaps to a divisor of the table
width, and the blocked plain decode (dense and intN pages) equals the
unblocked one for every legal block count, and the reference's blocked jnp
twin. Tuner selection laws, with the timings faked deterministic: ties break
toward the simplest schedule, the default is displaced only by a decisive
win, chunk widths are compared per token, and the same faked timings pick the
same winner in both packages' sweeps. The tuning table round-trips, ignores
foreign schemas, and a table written by either package loads in the other to
the same point. Engine integration: ``EngineConfig(autotune=True)`` fills
exactly the fields left at their auto sentinels, shows the decision in
``metrics()`` and the trace, leaves an engine without autotune unchanged, and
serves the same greedy tokens as the JAX engine on the same tuned shapes.
Tolerances: rtol 1e-5 / atol 1e-6 between blocked and unblocked f32 decodes
(the reference's), 1e-5 against the jnp twin.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import autotune as jax_autotune
from repro.kernels.paged_attention import paged_decode_attention_jnp
from repro.models import build_model as jax_build, get_config as jax_get_config
from repro.serving import GenerationParams as JaxGenerationParams
from repro.serving.engine import (
    EngineConfig as JaxEngineConfig,
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from repro_torch.kernels import autotune, ops
from repro_torch.kernels.paged_attention import (
    paged_decode_attention_quant_torch,
    paged_decode_attention_torch,
)
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams
from repro_torch.serving.engine import KV_DTYPES, EngineConfig, Request, ServeEngine


@pytest.fixture(scope="module")
def small_model():
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    return cfg, model, params


def _engine(model, params, conf):
    return ServeEngine(model, params, conf, device="cpu")


# =====================================================================================
# effective_block_pages — the divisor-snapping law
# =====================================================================================
def test_effective_block_pages_snaps_to_divisors():
    assert ops.effective_block_pages(None, 6) == 1
    assert ops.effective_block_pages(0, 6) == 1
    assert ops.effective_block_pages(1, 6) == 1
    assert ops.effective_block_pages(4, 6) == 3   # largest divisor <= 4
    assert ops.effective_block_pages(8, 6) == 6   # clamped to max_pages
    assert ops.effective_block_pages(100, 7) == 7
    assert ops.effective_block_pages(5, 7) == 1   # 7 prime: only 1 divides
    assert ops.effective_block_pages(4, 0) == 1   # degenerate table


# =====================================================================================
# blocked decode == unblocked decode (f32 and quantized, plain twin + dispatch)
# =====================================================================================
def _case(rng, *, b=3, hq=4, hkv=2, d=8, ps=4, max_pages=6):
    num_pages = b * max_pages + 1
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    pool = rng.standard_normal((2, num_pages, hkv, ps, d)).astype(np.float32)
    tables = (1 + np.arange(b * max_pages, dtype=np.int32)).reshape(b, max_pages)
    lens = np.asarray([max_pages * ps, 9, 5], np.int32)  # full / partial x2
    return q, pool[0], pool[1], tables, lens


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def test_blocked_plain_twin_matches_unblocked_f32():
    args = _t(*_case(np.random.default_rng(3)))
    ref = paged_decode_attention_torch(*args)
    for bp in (2, 3, 6):
        out = paged_decode_attention_torch(*args, block_pages=bp)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("bp", [2, 3, 6])
def test_blocked_plain_twin_matches_reference_jnp_twin(bp):
    arrays = _case(np.random.default_rng(3))
    want = paged_decode_attention_jnp(*map(jnp.asarray, arrays), block_pages=bp)
    got = paged_decode_attention_torch(*_t(*arrays), block_pages=bp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("bits", [8, 4])
def test_blocked_quant_twin_matches_unblocked(bits):
    q, k, v, tables, lens = _t(*_case(np.random.default_rng(4)))
    spec = KV_DTYPES["int8" if bits == 8 else "int4"]
    ek, ev = spec.encode_pages(k), spec.encode_pages(v)
    ref = paged_decode_attention_quant_torch(
        q, ek["q"], ek["scale"], ev["q"], ev["scale"], tables, lens, bits=bits)
    for bp in (2, 3):
        out = paged_decode_attention_quant_torch(
            q, ek["q"], ek["scale"], ev["q"], ev["scale"], tables, lens, bits=bits,
            block_pages=bp)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


def test_ops_dispatch_snaps_illegal_block_pages():
    """ops.paged_decode_attention accepts any block_pages (it snaps through
    effective_block_pages); the value holds for counts that do not divide the
    table width."""
    args = _t(*_case(np.random.default_rng(5)))
    ref = ops.paged_decode_attention(*args)
    for bp in (None, 1, 4, 100):
        out = ops.paged_decode_attention(*args, block_pages=bp)
        np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5, atol=1e-6)


# =====================================================================================
# tuner selection laws (measurements faked deterministic)
# =====================================================================================
def _fake_sweep(module, monkeypatch, times_us, cfg, **kw):
    """``module.sweep`` with its decode timings taken from ``times_us`` in the
    candidate walk order (page sizes outer, block_pages inner) and the chunk
    sweep pinned to 2 * page_size."""
    page_sizes = tuple(sorted({ps for ps, _ in times_us}))
    block_pages = tuple(sorted({bp for _, bp in times_us}))
    it = iter([times_us[(ps, bp)] for ps in page_sizes for bp in block_pages])
    monkeypatch.setattr(module, "_time_decode", lambda fn, args, reps=1: next(it) * 1e-6)
    monkeypatch.setattr(module, "sweep_chunk_tokens",
                        lambda cfg, *, page_size, **k: 2 * page_size)
    return module.sweep(cfg, page_sizes=page_sizes, block_pages=block_pages, **kw)


def _sweep_with(monkeypatch, times_us, **kw):
    return _fake_sweep(autotune, monkeypatch, times_us, get_config("qwen2-0.5b", smoke=True),
                       device="cpu", **kw)


def test_chunk_tokens_swept_per_token(monkeypatch):
    """Chunk widths are compared per token, the tie band breaking to 2 * page_size."""
    cfg = get_config("qwen2-0.5b", smoke=True)
    # dispatch-bound host: the same wall a call, so the widest chunk wins per token
    monkeypatch.setattr(autotune, "_time_decode", lambda fn, args, reps=1: 1e-4)
    assert autotune.sweep_chunk_tokens(cfg, page_size=16, batch=2, device="cpu") == 64
    # compute-bound host: wall scales with width, every candidate ties per
    # token and the default 2 * page_size keeps its seat
    widths = iter((16, 32, 64))
    monkeypatch.setattr(autotune, "_time_decode", lambda fn, args, reps=1: 1e-6 * next(widths))
    assert autotune.sweep_chunk_tokens(cfg, page_size=16, batch=2, device="cpu") == 32


def test_sweep_ties_break_to_simplest_schedule(monkeypatch):
    point = _sweep_with(monkeypatch, {(8, 1): 100, (8, 2): 99, (16, 1): 101, (16, 2): 103})
    assert (point.page_size, point.block_pages) == (16, 1)
    assert point.chunk_tokens == 2 * 16
    assert point.source == "swept"


def test_sweep_default_displaced_only_by_decisive_win(monkeypatch):
    # 15% faster is not decisive: the (16, 1) anchor keeps its seat
    point = _sweep_with(monkeypatch, {(8, 1): 85, (8, 2): 100, (16, 1): 100, (16, 2): 100})
    assert (point.page_size, point.block_pages) == (16, 1)
    # 2x faster is: the winner displaces the anchor
    point = _sweep_with(monkeypatch, {(8, 1): 50, (8, 2): 100, (16, 1): 100, (16, 2): 100})
    assert (point.page_size, point.block_pages) == (8, 1)


@pytest.mark.parametrize("times_us", [
    {(8, 1): 100, (8, 2): 99, (16, 1): 101, (16, 2): 103},
    {(8, 1): 85, (8, 2): 100, (16, 1): 100, (16, 2): 100},
    {(8, 1): 50, (8, 2): 100, (16, 1): 100, (16, 2): 100},
    {(8, 1): 90, (8, 4): 40, (16, 1): 100, (16, 4): 41, (32, 1): 300, (32, 4): 44},
])
def test_same_timings_same_winner_as_reference(monkeypatch, times_us):
    cfg_j = jax_get_config("qwen2-0.5b", smoke=True)
    want = _fake_sweep(jax_autotune, monkeypatch, times_us, cfg_j)
    got = _sweep_with(monkeypatch, times_us)
    assert got.as_dict() == want.as_dict()


def test_same_chunk_timings_same_width_as_reference(monkeypatch):
    for module, kw in ((jax_autotune, {}), (autotune, {"device": "cpu"})):
        widths = iter((16, 40, 64))
        monkeypatch.setattr(module, "_time_decode",
                            lambda fn, args, reps=1, _w=widths: 1e-6 * next(_w))
        cfg = (jax_get_config if module is jax_autotune else get_config)("qwen2-0.5b",
                                                                          smoke=True)
        assert module.sweep_chunk_tokens(cfg, page_size=16, batch=2, **kw) == 16


def test_cache_roundtrip_and_schema_guard(tmp_path):
    path = tmp_path / "tune.json"
    assert autotune.load_cache(path) == {}  # missing file -> empty, no raise
    entries = {"m/f32/b4": autotune.default_point().as_dict()}
    autotune.save_cache(path, entries)
    assert autotune.load_cache(path) == entries
    path.write_text(json.dumps({"schema": 999, "entries": entries}))
    assert autotune.load_cache(path) == {}  # foreign schema -> ignored
    path.write_text("not json")
    assert autotune.load_cache(path) == {}


@pytest.mark.parametrize("tag,kv,batch,seq", [
    ("qwen2-0.5b", "f32", 8, 0), ("qwen2-0.5b", "int8", 3, 33), ("granite-8b", "int4", 5, 577),
    ("m", "f32", 1, 1), ("m", "f32", 64, 4096),
])
def test_tuning_key_equals_reference(tag, kv, batch, seq):
    assert autotune.tuning_key(tag, kv, batch, seq) == jax_autotune.tuning_key(tag, kv, batch, seq)
    assert autotune.CACHE_SCHEMA == jax_autotune.CACHE_SCHEMA


def test_constants_equal_reference():
    for name in ("PAGE_SIZE_CANDIDATES", "BLOCK_PAGES_CANDIDATES", "CHUNK_PAGE_MULTIPLIERS",
                 "_SWEEP_SEQ_PAGES", "_SWEEP_REPS", "_SWEEP_WARMUP", "_SWEEP_TIE_X",
                 "_SWEEP_DISPLACE_X", "DEFAULT_CACHE_PATH"):
        assert getattr(autotune, name) == getattr(jax_autotune, name), name


_POINT = dict(page_size=32, block_pages=4, chunk_tokens=128, source="swept", us_per_step=12.5)


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_table_loads_across_packages(tmp_path, writer):
    """A table saved by either package loads in the other, byte-identical,
    and resolves there to the same cached point."""
    path = tmp_path / "tune.json"
    key = autotune.tuning_key("qwen2-smoke", "int8", 8, 300)
    src, dst = ((jax_autotune, autotune) if writer == "reference"
                else (autotune, jax_autotune))
    src.save_cache(path, {key: src.TunedPoint(**_POINT).as_dict()})
    text = path.read_text()
    dst.save_cache(tmp_path / "again.json", dst.load_cache(path))
    assert (tmp_path / "again.json").read_text() == text
    got = autotune.resolve(get_config("qwen2-0.5b", smoke=True), kv_dtype="int8", batch=8,
                           seq_len=300, cache_path=path, allow_sweep=False)
    want = jax_autotune.resolve(jax_get_config("qwen2-0.5b", smoke=True), kv_dtype="int8",
                                batch=8, seq_len=300, cache_path=path, allow_sweep=False)
    assert got.as_dict() == want.as_dict() == {**_POINT, "source": "cached"}


def test_resolve_cold_warm_and_projection(tmp_path, monkeypatch):
    cfg = get_config("qwen2-0.5b", smoke=True)
    path = tmp_path / "tune.json"
    # cold + allow_sweep=False: the default point, nothing written
    p = autotune.resolve(cfg, batch=4, cache_path=path, allow_sweep=False)
    assert p.source == "default" and not path.exists()
    # cold + sweep (timings faked): the winner lands in the cache
    monkeypatch.setattr(autotune, "_time_decode", lambda fn, args, reps=1: 1e-4)
    p = autotune.resolve(cfg, batch=4, seq_len=64, cache_path=path, device="cpu")
    assert p.source == "swept" and path.exists()
    key = autotune.tuning_key(cfg.name, "f32", 4, 64)
    assert key in autotune.load_cache(path)

    def boom(*a, **k):
        raise AssertionError("warm resolve must not re-sweep")

    monkeypatch.setattr(autotune, "_time_decode", boom)
    p2 = autotune.resolve(cfg, batch=4, seq_len=64, cache_path=path)
    assert p2.source == "cached"
    assert (p2.page_size, p2.block_pages) == (p.page_size, p.block_pages)
    # a pinned page_size projects the cached entry onto the pinned extent
    p3 = autotune.resolve(cfg, batch=4, seq_len=64, cache_path=path, page_size=8)
    assert p3.page_size == 8 and p3.chunk_tokens == 16
    # batch buckets: 3 and 4 share the pow2 bucket, 5 does not
    assert autotune.tuning_key("m", "f32", 3) == autotune.tuning_key("m", "f32", 4)
    assert autotune.tuning_key("m", "f32", 5) != autotune.tuning_key("m", "f32", 4)
    assert autotune.tuning_key("m", "f32", 4, 33) == autotune.tuning_key("m", "f32", 4, 64)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_real_sweep_on_cpu_times_every_candidate(kv_dtype, monkeypatch):
    """An unfaked sweep on the CPU runs every candidate through the plain
    decode and chunk paths (one rep each), blocked ones included, and returns
    a point on the grid."""
    calls = []
    real = autotune._time_decode
    monkeypatch.setattr(autotune, "_time_decode",
                        lambda fn, args, reps=1: calls.append(1) or real(fn, args, reps=1))
    cfg = get_config("qwen2-0.5b", smoke=True)
    p = autotune.sweep(cfg, kv_dtype=kv_dtype, batch=2, seq_len=64, page_sizes=(8, 16),
                       block_pages=(1, 2), device="cpu")
    assert len(calls) == 2 * 2 + 3  # the decode grid, then three chunk widths
    assert p.page_size in (8, 16) and p.block_pages in (1, 2)
    assert p.chunk_tokens in (p.page_size, 2 * p.page_size, 4 * p.page_size)


# =====================================================================================
# engine integration: sentinels filled, decision surfaced, opt-out untouched
# =====================================================================================
def _seed_cache(path, cfg, kv_dtype, batch, seq_len, point):
    autotune.save_cache(path, {autotune.tuning_key(cfg.name, kv_dtype, batch, seq_len):
                               point.as_dict()})


def test_engine_autotune_fills_sentinels_and_surfaces(small_model, tmp_path, monkeypatch):
    cfg, model, params = small_model
    path = tmp_path / "tune.json"
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", path)
    tuned = autotune.TunedPoint(page_size=8, block_pages=2, chunk_tokens=16, source="swept",
                                us_per_step=1.0)
    _seed_cache(path, cfg, "f32", 2, 40, tuned)
    conf = EngineConfig.sized_for(40, page_size=0, max_batch=2, autotune=True, trace=True)
    eng = _engine(model, params, conf)
    # page_size=0 materialized from the cache at init: the pool sized at ps 8
    assert eng.config.page_size == 8
    assert eng.config.decode_block_pages == 2
    pps = -(-40 // 8) + 1
    assert eng.config.max_pages_per_seq == pps
    assert eng.config.num_pages == 2 * pps + 1
    assert eng.cache.page_size == 8
    assert eng.tuned is not None and eng.tuned.source == "cached"
    assert eng.metrics()["tuned_source"] == "cached"  # the empty snapshot carries it too
    # the engine runs with the tuned shapes
    eng.run([Request(rid=0, prompt=[1, 2, 3], params=GenerationParams(max_new_tokens=4))])
    m = eng.metrics()
    assert m["tuned_page_size"] == 8
    assert m["tuned_block_pages"] == 2
    assert m["tuned_source"] == "cached"
    names = [ev.name for ev in eng.trace.events]
    assert "tuning_selected" in names


def test_engine_autotune_fills_chunk_tokens(small_model, tmp_path, monkeypatch):
    cfg, model, params = small_model
    path = tmp_path / "tune.json"
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", path)
    _seed_cache(path, cfg, "f32", 2, 40, autotune.TunedPoint(
        page_size=4, block_pages=1, chunk_tokens=16, source="swept", us_per_step=1.0))
    eng = _engine(model, params, EngineConfig.sized_for(
        40, page_size=0, max_batch=2, autotune=True, chunked_prefill=True, chunk_tokens=0))
    assert (eng.config.page_size, eng.config.chunk_tokens, eng._chunk_tokens) == (4, 16, 16)
    # a pinned chunk width survives
    eng = _engine(model, params, EngineConfig.sized_for(
        40, page_size=0, max_batch=2, autotune=True, chunked_prefill=True, chunk_tokens=8))
    assert eng.config.chunk_tokens == 8


def test_engine_autotune_respects_pinned_fields(small_model, tmp_path, monkeypatch):
    cfg, model, params = small_model
    path = tmp_path / "tune.json"
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", path)
    tuned = autotune.TunedPoint(page_size=16, block_pages=4, chunk_tokens=32, source="swept",
                                us_per_step=1.0)
    _seed_cache(path, cfg, "f32", 2, 40, tuned)
    # page_size pinned: the tuner only fills decode_block_pages (the cached
    # entry is projected onto the pinned extent)
    eng = _engine(model, params, EngineConfig.sized_for(40, page_size=4, max_batch=2,
                                                        autotune=True))
    assert eng.config.page_size == 4
    assert eng.config.decode_block_pages == 4
    # ...and a pinned decode_block_pages survives tuning untouched
    eng2 = _engine(model, params, EngineConfig.sized_for(40, page_size=4, max_batch=2,
                                                         autotune=True, decode_block_pages=1))
    assert eng2.config.decode_block_pages == 1


def test_engine_without_autotune_unchanged(small_model):
    cfg, model, params = small_model
    eng = _engine(model, params, EngineConfig(num_pages=16, page_size=4, max_batch=2))
    assert eng.tuned is None
    assert eng.metrics() == {}  # the empty snapshot, no tuned_* keys
    with pytest.raises(ValueError):
        EngineConfig.sized_for(40, page_size=0, max_batch=2)  # needs autotune


def _greedy_requests(vocab, n=2):
    return [(np.random.default_rng(30 + i).integers(1, vocab, size=6).tolist(), 8)
            for i in range(n)]


def test_engine_blocked_decode_matches_unblocked(small_model):
    """The knob end to end: the same greedy trace with decode_block_pages
    pinned at 2 and unblocked is token-exact."""
    cfg, model, params = small_model
    outs = {}
    for bp in (0, 2):
        conf = EngineConfig.sized_for(16, page_size=4, max_batch=2, decode_block_pages=bp)
        eng = _engine(model, params, conf)
        results = eng.run([Request(i, p, GenerationParams(max_new_tokens=n))
                           for i, (p, n) in enumerate(_greedy_requests(cfg.vocab))])
        outs[bp] = {rid: s.generated for rid, s in results.items()}
    assert outs[0] == outs[2]


def test_engine_autotune_matches_reference_engine(tmp_path, monkeypatch):
    """Both packages' engines read one tuning table (written by the
    reference), size their pools from it and serve the same greedy tokens
    through the blocked decode; their tuned_* metrics agree."""
    path = tmp_path / "tune.json"
    monkeypatch.setattr(autotune, "DEFAULT_CACHE_PATH", path)
    monkeypatch.setattr(jax_autotune, "DEFAULT_CACHE_PATH", path)
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    jax_autotune.save_cache(path, {jax_autotune.tuning_key(cfg_j.name, "f32", 2, 24):
                                   jax_autotune.TunedPoint(page_size=8, block_pages=2,
                                                           chunk_tokens=8, source="swept",
                                                           us_per_step=3.0).as_dict()})
    spec = _greedy_requests(cfg.vocab)
    kw = dict(page_size=0, max_batch=2, autotune=True, chunked_prefill=True, chunk_tokens=0)
    eng_j = JaxServeEngine(model_j, params_j, JaxEngineConfig.sized_for(24, **kw))
    res_j = eng_j.run([JaxRequest(rid=i, prompt=p, params=JaxGenerationParams(max_new_tokens=n))
                       for i, (p, n) in enumerate(spec)])
    eng = _engine(model, params, EngineConfig.sized_for(24, **kw))
    res = eng.run([Request(i, p, GenerationParams(max_new_tokens=n))
                   for i, (p, n) in enumerate(spec)])
    assert {r: s.generated for r, s in res.items()} == {r: list(s.generated)
                                                          for r, s in res_j.items()}
    tuned = ("tuned_page_size", "tuned_block_pages", "tuned_chunk_tokens", "tuned_source")
    m, m_j = eng.metrics(), eng_j.metrics()
    assert {k: m[k] for k in tuned} == {k: m_j[k] for k in tuned} == {
        "tuned_page_size": 8, "tuned_block_pages": 2, "tuned_chunk_tokens": 8,
        "tuned_source": "cached"}
    for f in ("num_pages", "max_pages_per_seq", "page_size", "decode_block_pages",
              "chunk_tokens", "sized_max_len"):
        assert getattr(eng.config, f) == getattr(eng_j.config, f), f
