"""repro_torch stands alone and never falls back quietly to the CPU.

Import hygiene: importing the port and every submodule pulls in neither JAX
nor the reference package. Entry points: without CUDA and without an
explicit ``device="cpu"``, the model, the engine and the weight bridge raise.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import repro_torch
from repro_torch.models import Model, build_model, from_jax_params, get_config
from repro_torch.serving.engine import EngineConfig, ServeEngine

SRC = Path(__file__).resolve().parents[1] / "src"

_HYGIENE = r"""
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print(len(names), bad)
assert not bad, bad
"""


def test_import_pulls_in_neither_jax_nor_repro():
    env = dict(os.environ, PYTHONPATH=str(SRC))
    out = subprocess.run([sys.executable, "-c", _HYGIENE], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 20  # every subpackage was walked


def test_package_mirrors_reference_names():
    root = Path(repro_torch.__file__).parent
    for rel in ("kernels/ops.py", "kernels/paged_attention.py", "kernels/quant_matmul.py",
                "core/accessors.py", "core/distributed.py", "models/attention.py",
                "models/transformer.py", "models/registry.py", "serving/step.py",
                "serving/engine/engine.py", "serving/engine/cache.py",
                "serving/engine/kvquant.py", "runtime/health.py"):
        assert (root / rel).exists(), rel
        assert (SRC / "repro" / rel).exists(), rel


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_model_without_device_raises_without_cuda(no_cuda):
    cfg = get_config("qwen2-0.5b", smoke=True)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(cfg)


def test_engine_without_device_raises_without_cuda(no_cuda):
    cfg = get_config("qwen2-0.5b", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine(model, params, EngineConfig(num_pages=8, page_size=4, max_batch=2))
    ServeEngine(model, params, EngineConfig(num_pages=8, page_size=4, max_batch=2), device="cpu")


def test_bridge_without_device_raises_without_cuda(no_cuda):
    cfg = get_config("qwen2-0.5b", smoke=True)
    tree = {"embed": {"embedding": np.zeros((512, 64), np.float32)}, "blocks": [{}],
            "final_norm": np.ones(64, np.float32)}
    with pytest.raises(RuntimeError, match="device='cpu'"):
        from_jax_params(tree, cfg)
