"""``ServeEngine(mesh=, rules=serve_rules(cfg))`` on 4 gloo ranks on the CPU
against the JAX package's one-device engine: qwen2 smoke in f32 on bridged
weights (the reference's init through ``from_jax_params``), five prompts of
3-16 tokens, 8 new tokens each, 4 slots over 40 pages of 4, on (2, 2), (4, 1)
and (1, 4) ("data", "model") meshes, over f32 pages with ``multi_step`` 1
and 4 and over int8 pages. Every rank runs its own engine loop on the same
requests (the same host decisions), its pools whole (``serve_rules``
replicate kv_heads), each step on the mesh: every rank writes every row's
K/V and attends its own rows with q's heads gathered, the logits gathered
whole, so each rank samples the same ids. Every rank's token streams equal
the JAX engine's one-device streams.
"""
import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from test_torch_multirank import check_case, mesh_of, rank_main, spawn_group  # noqa: E402

MESHES = ((2, 2), (4, 1), (1, 4))
MODES = {"f32": {}, "f32_multi4": {"multi_step": 4}, "int8": {"kv_dtype": "int8"}}
ECONF = dict(num_pages=40, page_size=4, max_batch=4, max_pages_per_seq=10)
N_NEW = 8


def _prompts(vocab):
    rng = np.random.default_rng(0)
    return [rng.integers(0, vocab, size=n).tolist() for n in (5, 9, 16, 3, 12)]


def _case(shape):
    def run(rank, workdir):
        from repro_torch.launch import serve_rules
        from repro_torch.models import build_model, get_config
        from repro_torch.serving import GenerationParams
        from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

        cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
        model = build_model(cfg, device="cpu")
        params = torch.load(workdir / "params.pt")
        mesh = mesh_of(shape)
        out = {}
        for mode, extra in MODES.items():
            eng = ServeEngine(model, params, EngineConfig(**ECONF, **extra), device="cpu",
                              mesh=mesh, rules=serve_rules(cfg))
            res = eng.run([Request(rid=i, prompt=p,
                                   params=GenerationParams(max_new_tokens=N_NEW))
                           for i, p in enumerate(_prompts(cfg.vocab))])
            out[mode] = {str(r): list(s.generated) for r, s in res.items()}
        (workdir / f"streams_{shape[0]}x{shape[1]}_{rank}.json").write_text(json.dumps(out))
    return run


def case_refuses_split_pools(rank, workdir):
    """Rules that split the pools (``train_rules``: kv_heads on "model",
    qwen2 smoke's 2 kv heads on a 2-way axis) are refused by leaf name."""
    import pytest as _pytest

    from repro_torch.launch import train_rules
    from repro_torch.models import build_model, get_config
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    with _pytest.raises(NotImplementedError, match="page pool leaf 0/k"):
        ServeEngine(model, params, EngineConfig(**ECONF), device="cpu", mesh=mesh_of((2, 2)),
                    rules=train_rules(cfg, fsdp=False))


CASES = {**{f"engine_{s[0]}x{s[1]}": _case(s) for s in MESHES},
         "refuses_split_pools": case_refuses_split_pools}


def jax_streams(params_j, cfg_j):
    from repro.models import build_model as jax_build
    from repro.serving import GenerationParams as JaxGenerationParams
    from repro.serving.engine import EngineConfig as JaxEngineConfig
    from repro.serving.engine import Request as JaxRequest
    from repro.serving.engine import ServeEngine as JaxServeEngine

    model_j = jax_build(cfg_j)
    out = {}
    for mode, extra in MODES.items():
        eng = JaxServeEngine(model_j, params_j, JaxEngineConfig(**ECONF, **extra))
        res = eng.run([JaxRequest(rid=i, prompt=p,
                                  params=JaxGenerationParams(max_new_tokens=N_NEW))
                       for i, p in enumerate(_prompts(cfg_j.vocab))])
        out[mode] = {str(r): list(map(int, s.generated)) for r, s in res.items()}
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    import jax

    from repro.models import build_model as jax_build
    from repro.models import get_config as jax_get_config
    from repro_torch.models import from_jax_params, get_config

    workdir = tmp_path_factory.mktemp("multirank_engine")
    cfg_j = dataclasses.replace(jax_get_config("qwen2-0.5b", smoke=True), dtype="float32")
    params_j = jax_build(cfg_j).init_params(jax.random.key(0))
    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    torch.save(from_jax_params(jax.tree.map(np.asarray, params_j), cfg, device="cpu"),
               workdir / "params.pt")
    results = spawn_group(__file__, workdir, meanwhile=lambda: jax_streams(params_j, cfg_j))
    return results, workdir, results["_meanwhile"]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_engine_case_on_every_rank(group, case):
    results, workdir, _ = group
    check_case(results, case, workdir)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_every_ranks_streams_equal_the_jax_engines(group, shape, mode):
    results, workdir, want = group
    check_case(results, f"engine_{shape[0]}x{shape[1]}", workdir)
    for rank in range(4):
        got = json.loads((workdir / f"streams_{shape[0]}x{shape[1]}_{rank}.json").read_text())
        assert got[mode] == want[mode], (rank, mode)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    rank_main(CASES)
