"""repro_torch's logits recording (``EngineConfig.record_logits``,
``ServeEngine.logits_of``, ``aligned_max_logit_err``) against the reference's
laws and against the JAX engine on bridged weights.

Ported from the reference: greedy tokens equal the host argmax of the
recorded rows over f32 and int8 pages (tests/test_sampling.py:138);
recording disables the fused K-step window (:244); intN pages keep the logit
error on identical contexts inside (0, 0.75) for int8 and (0, 2.0) for int4
while sharing and copying on write the same pages as f32 and holding the pool
>= 1.9x smaller (tests/test_serving_engine.py:314-348); a speculative engine
refuses recording (tests/test_speculative.py:327-330). Across packages, on
the qwen2 smoke model bridged from the JAX one, in f32: every recorded row
(the prefill's first token included) equals the JAX engine's within 1e-4
absolute, in both prefill regimes; ``aligned_max_logit_err`` of int8 / int4
pages against f32 agrees with the JAX package's within 1e-4; a request that
opts out (``record_logits=False``) records nothing, one that opts in on a
non-recording engine and every branch group are refused.
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
    aligned_max_logit_err as jax_aligned_max_logit_err,
)
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams
from repro_torch.serving.engine import (
    EngineConfig,
    Request,
    ServeEngine,
    aligned_max_logit_err,
)

ROW_ATOL = 1e-4
BOUNDS = {"int8": 0.75, "int4": 2.0}  # the reference's (tests/test_serving_engine.py:314)

# the reference's shared-prefix burst: a 10-token prefix (10 % 4 != 0, so the
# partly filled last page is shared and copied on write), twice alone and once
# extended
_rng = np.random.default_rng(6)
_PREFIX = _rng.integers(0, 512, size=10).tolist()
COW_PROMPTS = [list(_PREFIX), list(_PREFIX), _PREFIX + _rng.integers(0, 512, size=3).tolist()]
COW_CONF = dict(num_pages=32, page_size=4, max_batch=3, max_pages_per_seq=8, record_logits=True)
COW_NEW = 5

_rng = np.random.default_rng(0)
MIXED_PROMPTS = [_rng.integers(0, 512, size=n).tolist() for n in (5, 9, 12)]
MODES = {
    "monolithic": dict(num_pages=32, page_size=4, max_batch=3, max_pages_per_seq=8),
    "chunked": dict(num_pages=32, page_size=4, max_batch=3, max_pages_per_seq=8,
                    chunked_prefill=True, chunk_tokens=8),
}


def _jax_run(model_j, params_j, prompts, n, **conf):
    eng = JaxServeEngine(model_j, params_j, JaxEngineConfig(**conf))
    res = eng.run([JaxRequest(rid=i, prompt=list(p),
                              params=JaxGenerationParams(max_new_tokens=n))
                   for i, p in enumerate(prompts)])
    return eng, res


@pytest.fixture(scope="module")
def setup():
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model_j = jax_build(cfg_j)
    params_j = model_j.init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
    ref = {}
    for mode, conf in MODES.items():
        ref[mode] = _jax_run(model_j, params_j, MIXED_PROMPTS, 6, record_logits=True, **conf)
    for kv in ("f32", "int8", "int4"):
        ref[kv] = _jax_run(model_j, params_j, COW_PROMPTS, COW_NEW, kv_dtype=kv, **COW_CONF)
    ref["model"] = (model_j, params_j)
    return cfg, model, params, ref


def _run(model, params, prompts, n, **conf):
    eng = ServeEngine(model, params, EngineConfig(**conf), device="cpu")
    res = eng.run([Request(i, list(p), GenerationParams(max_new_tokens=n))
                   for i, p in enumerate(prompts)])
    return eng, res


# ---------------------------------------------------------------------------------
# the reference's laws
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_engine_greedy_on_device_matches_host_argmax(setup, kv_dtype):
    """Every generated token equals the host argmax of the row recorded for
    it, over f32 and quantized pools."""
    cfg, model, params, _ = setup
    eng, results = _run(model, params, MIXED_PROMPTS, 6, record_logits=True, kv_dtype=kv_dtype,
                        **MODES["monolithic"])
    for rid, state in results.items():
        rows = eng.logits_of[rid]
        assert len(rows) == len(state.generated) == 6
        for n, tok in enumerate(state.generated):
            assert rows[n].shape == (cfg.vocab,) and rows[n].dtype == np.float32
            assert tok == int(np.argmax(rows[n])), (rid, n)


def test_engine_record_logits_disables_fusion(setup):
    cfg, model, params, _ = setup
    prompt = np.random.default_rng(6).integers(0, cfg.vocab, size=8).tolist()
    eng, res = _run(model, params, [prompt], 8, num_pages=16, page_size=16, max_batch=1,
                    max_pages_per_seq=4, multi_step=4, record_logits=True)
    assert eng.metrics()["fused_steps"] == 0  # the slow path: per-step rows on the host
    assert len(eng.logits_of[0]) == len(res[0].generated) == 8
    # without recording the same engine fuses
    eng, _ = _run(model, params, [prompt], 8, num_pages=16, page_size=16, max_batch=1,
                  max_pages_per_seq=4, multi_step=4)
    assert eng.metrics()["fused_steps"] > 0 and eng.logits_of == {}


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_engine_quantized_kv_bounded_error_and_smaller_pool(setup, kv_dtype):
    """The shared-prefix burst through an f32 and an intN engine: every
    request completes, sharing and CoW fire identically, the pool holds the
    same pages in far fewer bytes, and the logits on identical contexts stay
    inside the reference's bound."""
    cfg, model, params, _ = setup
    eng_f32, res_f32 = _run(model, params, COW_PROMPTS, COW_NEW, **COW_CONF)
    eng_q, res_q = _run(model, params, COW_PROMPTS, COW_NEW, kv_dtype=kv_dtype, **COW_CONF)
    assert set(res_q) == set(range(len(COW_PROMPTS)))
    assert all(len(res_q[r].generated) == COW_NEW for r in res_q)
    m_f32, m_q = eng_f32.metrics(), eng_q.metrics()
    assert m_q["pages_shared"] == m_f32["pages_shared"] > 0
    assert m_q["cow_copies"] == m_f32["cow_copies"] >= 1
    assert m_q["peak_pages_in_use"] == m_f32["peak_pages_in_use"]
    assert m_f32["kv_pool_bytes"] / m_q["kv_pool_bytes"] >= 1.9
    err = aligned_max_logit_err(eng_f32, eng_q, res_f32, res_q)
    assert 0 < err < BOUNDS[kv_dtype], f"{kv_dtype} max logit err {err}"


def test_spec_engine_refuses_record_logits(setup):
    cfg, model, params, _ = setup
    spec_conf = EngineConfig(num_pages=32, page_size=4, max_batch=2, max_pages_per_seq=8,
                             spec_tokens=3)
    with pytest.raises(ValueError, match="record_logits"):
        ServeEngine(model, params, dataclasses.replace(spec_conf, record_logits=True),
                    device="cpu")


# ---------------------------------------------------------------------------------
# against the JAX engine on the same weights
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("mode", list(MODES))
def test_recorded_rows_match_reference_engine(setup, mode):
    cfg, model, params, ref = setup
    eng_j, res_j = ref[mode]
    eng, res = _run(model, params, MIXED_PROMPTS, 6, record_logits=True, **MODES[mode])
    assert {r: s.generated for r, s in res.items()} == {r: list(s.generated)
                                                          for r, s in res_j.items()}
    assert set(eng.logits_of) == set(eng_j.logits_of) == set(range(len(MIXED_PROMPTS)))
    for rid, rows in eng.logits_of.items():
        assert sorted(rows) == sorted(eng_j.logits_of[rid]) == list(range(6))
        for n, row in rows.items():
            np.testing.assert_allclose(row, eng_j.logits_of[rid][n], rtol=0, atol=ROW_ATOL,
                                       err_msg=f"rid {rid} token {n}")


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_aligned_max_logit_err_matches_reference(setup, kv_dtype):
    cfg, model, params, ref = setup
    want = jax_aligned_max_logit_err(ref["f32"][0], ref[kv_dtype][0], ref["f32"][1],
                                     ref[kv_dtype][1])
    eng_f32, res_f32 = _run(model, params, COW_PROMPTS, COW_NEW, **COW_CONF)
    eng_q, res_q = _run(model, params, COW_PROMPTS, COW_NEW, kv_dtype=kv_dtype, **COW_CONF)
    got = aligned_max_logit_err(eng_f32, eng_q, res_f32, res_q)
    assert abs(got - want) <= ROW_ATOL, (got, want)
    # the port's function over the reference's engines gives the reference's number
    assert aligned_max_logit_err(ref["f32"][0], ref[kv_dtype][0], ref["f32"][1],
                                 ref[kv_dtype][1]) == want


def test_opt_out_and_opt_in(setup):
    """record_logits=False keeps a request out of logits_of (and its rows off
    the fetch); True needs a recording engine; None follows the engine."""
    cfg, model, params, ref = setup
    eng = ServeEngine(model, params, EngineConfig(record_logits=True, **MODES["monolithic"]),
                      device="cpu")
    flags = (None, False, True)
    for i, (p, flag) in enumerate(zip(MIXED_PROMPTS, flags)):
        eng.submit(p, GenerationParams(max_new_tokens=6, record_logits=flag), rid=i)
    res = eng.run()
    assert sorted(eng.logits_of) == [0, 2]
    eng_j = ref["monolithic"][0]
    for rid in (0, 2):
        for n, row in eng.logits_of[rid].items():
            np.testing.assert_allclose(row, eng_j.logits_of[rid][n], rtol=0, atol=ROW_ATOL)
    assert res[1].generated == list(ref["monolithic"][1][1].generated)
    eng.reset_metrics()
    assert eng.logits_of == {} and eng.results == {}
    plain = ServeEngine(model, params, EngineConfig(**MODES["monolithic"]), device="cpu")
    with pytest.raises(ValueError, match="record_logits"):
        plain.submit(MIXED_PROMPTS[0], GenerationParams(record_logits=True))
    plain.submit(MIXED_PROMPTS[0], GenerationParams(max_new_tokens=2, record_logits=False))
    plain.run()
    assert plain.logits_of == {}


@pytest.mark.parametrize("kw", [dict(n=2, temperature=0.8), dict(beam_width=2)])
def test_groups_refused_while_recording(setup, kw):
    cfg, model, params, ref = setup
    eng = ServeEngine(model, params,
                      EngineConfig(record_logits=True, max_beam_width=2, **MODES["monolithic"]),
                      device="cpu")
    with pytest.raises(ValueError, match="record_logits"):
        eng.submit(MIXED_PROMPTS[0], GenerationParams(max_new_tokens=4, **kw))
    # the reference refuses the same request the same way
    eng_j = JaxServeEngine(*ref["model"], JaxEngineConfig(
        record_logits=True, max_beam_width=2, **MODES["monolithic"]))
    with pytest.raises(ValueError, match="record_logits"):
        eng_j.submit(MIXED_PROMPTS[0], JaxGenerationParams(max_new_tokens=4, **kw))

