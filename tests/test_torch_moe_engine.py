"""The serving engine on the MoE family: repro_torch's ServeEngine against the
JAX package's on the same (bridged) weights.

Greedy streams must be token-identical: dbrx-smoke and kimi-smoke over f32
pages with monolithic and with chunked prefill; dbrx-smoke over int8 pages;
dbrx-smoke with speculative decoding (spec_tokens 4), whose verify step
routes B * (K + 1) rows through the experts, so capacity is exercised at the
verify width. Every routed row takes capacity in both packages (padding,
inactive slots, rejected draft rows), so any trimming would show as a token
difference.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.serving import GenerationParams as JaxGenerationParams
from repro.serving.engine import (
    EngineConfig as JaxEngineConfig,
    Request as JaxRequest,
    ServeEngine as JaxServeEngine,
)
from repro_torch.serving import GenerationParams
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
from tests.test_torch_moe_models import bridged_pair

BASE = dict(num_pages=24, page_size=4, max_batch=2, max_pages_per_seq=10)
MODES = {
    "monolithic": BASE,
    "chunked": dict(BASE, chunked_prefill=True, chunk_tokens=8),
}
_rng = np.random.default_rng(21)
PROMPTS = [_rng.integers(0, 512, size=n).tolist() for n in (7, 16, 21)]
N_NEW = 8
_MODELS = {}


def _models(arch):
    if arch not in _MODELS:
        _MODELS[arch] = bridged_pair(arch, 3)[1:]
    return _MODELS[arch]


def _both(arch, econf, prompts=PROMPTS, n_new=N_NEW):
    model_j, params_j, model, params = _models(arch)
    eng_j = JaxServeEngine(model_j, params_j, JaxEngineConfig(**econf))
    want = eng_j.run([JaxRequest(rid=i, prompt=list(p),
                                 params=JaxGenerationParams(max_new_tokens=n_new))
                      for i, p in enumerate(prompts)])
    eng = ServeEngine(model, params, EngineConfig(**econf), device="cpu")
    got = eng.run([Request(i, list(p), GenerationParams(max_new_tokens=n_new))
                   for i, p in enumerate(prompts)])
    assert all(len(s.generated) == n_new for s in got.values())
    assert {r: s.generated for r, s in got.items()} == {r: list(s.generated)
                                                          for r, s in want.items()}
    return eng.metrics(), eng_j.metrics()


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ["dbrx-132b", "kimi-k2-1t-a32b"])
def test_engine_greedy_matches_reference_engine(arch, mode):
    m, m_j = _both(arch, MODES[mode])
    for k in ("preemptions", "pages_shared", "prefill_tokens_computed"):
        assert m[k] == m_j[k], k


def test_engine_int8_pages_match_reference_engine():
    m, m_j = _both("dbrx-132b", dict(MODES["chunked"], kv_dtype="int8"))
    assert m["kv_pool_bytes"] == m_j["kv_pool_bytes"]


def test_engine_spec_verify_matches_reference_engine():
    """spec_tokens 4: the verify window is C = 5 rows a request, B * 5 rows
    routed at once. Prompts that repeat so the n-gram drafts hit."""
    rng = np.random.default_rng(22)
    prompts = [(rng.integers(0, 512, size=4).tolist() * 3)[:10] for _ in range(2)]
    econf = dict(BASE, num_pages=40, spec_tokens=4, spec_backoff=0)
    m, m_j = _both("dbrx-132b", econf, prompts, n_new=12)
    assert m["spec_windows"] > 0
    for k in ("spec_windows", "spec_accepted_tokens", "spec_rollback_tokens", "decode_steps"):
        assert m[k] == m_j[k], k
