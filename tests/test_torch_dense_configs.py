"""The dense configs llama3.2-1b, qwen2.5-3b and granite-8b in repro_torch,
held against the JAX package.

For each: the full and smoke ``ModelConfig`` equal the reference's field for
field (head dim, group and padded vocab included: llama3.2-1b's 128256 pads
to itself at 256, as in the reference); the smoke model's forward logits on
weights bridged from the JAX model agree within rtol / atol 1e-4 in f32 (the
tolerance of test_torch_model.py: the two packages sum in different orders);
the paged engine's greedy streams equal the JAX engine's on three requests
with monolithic and with chunked prefill. qwen2.5-3b and granite-8b do not
tie their embeddings: the bridge carries the reference's ``lm_head`` leaf,
the port's specs give it the reference's shape, and the logits read it (and
not the embedding).
"""
import dataclasses

import jax
import jax.numpy as jnp
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
from repro_torch.models import ModelConfig, build_model, from_jax_params, get_config
from repro_torch.serving import GenerationParams
from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

ARCHS = ("llama3.2-1b", "qwen2.5-3b", "granite-8b")
TOL = dict(rtol=1e-4, atol=1e-4)
# the full configs' attention geometry: (Hq, Hkv, D), the group Hq / Hkv
GEOMETRY = {"llama3.2-1b": (32, 8, 64), "qwen2.5-3b": (16, 2, 128), "granite-8b": (32, 8, 128)}
UNTIED = ("qwen2.5-3b", "granite-8b")
MODES = {
    "monolithic": dict(num_pages=24, page_size=4, max_batch=2, max_pages_per_seq=10),
    "chunked": dict(num_pages=24, page_size=4, max_batch=2, max_pages_per_seq=10,
                    chunked_prefill=True, chunk_tokens=8),
}
_rng = np.random.default_rng(11)
PROMPTS = [_rng.integers(0, 512, size=n).tolist() for n in (7, 16, 21)]
N_NEW = 8

_MODELS = {}


def _models(arch):
    """(cfg, JAX model, JAX params, port model, bridged params), f32 smoke."""
    if arch not in _MODELS:
        cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
        model_j = jax_build(cfg_j)
        params_j = model_j.init_params(jax.random.key(3))
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        model = build_model(cfg, device="cpu")
        params = from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu")
        _MODELS[arch] = (cfg, model_j, params_j, model, params)
    return _MODELS[arch]


@pytest.mark.parametrize("smoke", [False, True])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference(arch, smoke):
    ref = jax_get_config(arch, smoke=smoke)
    cfg = get_config(arch, smoke=smoke)
    for f in dataclasses.fields(ModelConfig):
        assert getattr(cfg, f.name) == getattr(ref, f.name), f.name
    # the reference's fields the port has no use for stay at their defaults
    ported = {f.name for f in dataclasses.fields(ModelConfig)}
    for f in dataclasses.fields(type(ref)):
        if f.name not in ported:
            assert getattr(ref, f.name) == f.default, f.name
    assert (cfg.head_dim, cfg.vocab_padded) == (ref.head_dim, ref.vocab_padded)
    assert cfg.tie_embeddings == (arch not in UNTIED)
    if not smoke:
        assert (cfg.n_heads, cfg.n_kv_heads, cfg.head_dim) == GEOMETRY[arch]
    if arch == "llama3.2-1b" and not smoke:
        assert cfg.vocab_padded == ref.vocab_padded == 128256


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_match_reference(arch):
    """The port's parameter tree has the reference's leaves, shapes and
    dtypes (the untied lm_head included), layer by layer."""
    cfg, model_j, params_j, model, _ = _models(arch)
    p = model.init_params(torch.Generator().manual_seed(0))
    want = jax.tree.map(lambda a: (a.shape, a.dtype.name), params_j["embed"])
    got = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]), p["embed"])
    assert got == want
    assert ("lm_head" in got) == (arch in UNTIED)
    ref_layer = jax.tree.map(lambda a: (a.shape[1:], a.dtype.name), params_j["blocks"][0])
    mine = jax.tree.map(lambda t: (tuple(t.shape), str(t.dtype).split(".")[1]),
                        p["blocks"][0][0])
    assert mine == ref_layer


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match(arch):
    cfg, model_j, params_j, model, params = _models(arch)
    toks = np.random.default_rng(1).integers(0, cfg.vocab, size=(2, 24)).astype(np.int32)
    want, _ = model_j.forward(params_j, jnp.asarray(toks), remat=False)
    got, _ = model.forward(params, torch.from_numpy(toks))
    assert got.shape == (2, 24, cfg.vocab_padded)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("arch", UNTIED)
def test_untied_lm_head_is_bridged_and_read(arch):
    cfg, _, params_j, model, params = _models(arch)
    head = params["embed"]["lm_head"]
    np.testing.assert_array_equal(head.numpy(), np.asarray(params_j["embed"]["lm_head"]))
    assert tuple(head.shape) == (cfg.d_model, cfg.vocab_padded)
    assert not torch.equal(head, params["embed"]["embedding"].t())
    # the logits read lm_head: zeroing it zeroes the real vocab's logits
    toks = torch.tensor([[1, 2, 3]])
    zeroed = {**params, "embed": {**params["embed"], "lm_head": torch.zeros_like(head)}}
    logits, _ = model.forward(zeroed, toks)
    assert torch.all(logits[..., :cfg.vocab] == 0)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_greedy_matches_reference_engine(arch, mode):
    cfg, model_j, params_j, model, params = _models(arch)
    eng_j = JaxServeEngine(model_j, params_j, JaxEngineConfig(**MODES[mode]))
    want = eng_j.run([JaxRequest(rid=i, prompt=list(p),
                                 params=JaxGenerationParams(max_new_tokens=N_NEW))
                      for i, p in enumerate(PROMPTS)])
    eng = ServeEngine(model, params, EngineConfig(**MODES[mode]), device="cpu")
    got = eng.run([Request(i, list(p), GenerationParams(max_new_tokens=N_NEW))
                   for i, p in enumerate(PROMPTS)])
    assert {r: s.generated for r, s in got.items()} == {r: list(s.generated)
                                                          for r, s in want.items()}
    assert all(len(s.generated) == N_NEW for s in got.values())
    m, m_j = eng.metrics(), eng_j.metrics()
    for k in ("preemptions", "pages_shared", "prefill_tokens_computed"):
        assert m[k] == m_j[k], k
