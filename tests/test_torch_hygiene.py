"""repro_torch stands alone and never falls back quietly to the CPU.

Import hygiene: importing the port and every submodule pulls in neither JAX
nor the reference package. Entry points: without CUDA and without an
explicit ``device="cpu"``, the model, the engine and the weight bridge raise.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

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
                "kernels/sum3d.py", "kernels/stencil3d.py", "kernels/tinymatsum.py",
                "kernels/matvec.py", "kernels/common.py", "kernels/flash_attention.py",
                "kernels/ssd_scan.py", "models/ssm.py", "configs/mamba2_780m.py",
                "core/extents.py", "core/layouts.py",
                "core/mdspan.py", "core/submdspan.py", "core/algorithms.py",
                "core/instrument.py",
                "core/accessors.py", "core/distributed.py", "models/attention.py",
                "models/transformer.py", "models/registry.py", "serving/step.py",
                "serving/engine/engine.py", "serving/engine/cache.py",
                "serving/engine/kvquant.py", "runtime/health.py"):
        assert (root / rel).exists(), rel
        assert (SRC / "repro" / rel).exists(), rel


_NAMES = r"""
import importlib, json, sys
pkg = sys.argv[1]
out = {}
for mod in ("core", "core.accessors", "core.layouts", "kernels.sum3d", "kernels.stencil3d",
            "kernels.tinymatsum", "kernels.matvec", "kernels.ops"):
    m = importlib.import_module(f"{pkg}.{mod}")
    out[mod] = sorted(n for n in dir(m) if not n.startswith("_"))
out["core.__all__"] = list(importlib.import_module(f"{pkg}.core").__all__)
print(json.dumps(out))
"""


def _public_names(pkg: str) -> dict:
    env = dict(os.environ, PYTHONPATH=str(SRC), JAX_PLATFORMS="cpu")
    out = subprocess.run([sys.executable, "-c", _NAMES, pkg], env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return json.loads(out.stdout)


def test_core_and_paper_kernels_mirror_reference_names():
    """Every name of repro.core.__all__ exists in repro_torch.core, and the
    four paper-suite kernel modules (and ops) keep the reference's public
    kernel entry points: the Pallas ``*_pallas`` functions under the
    wrapper's name, and ``*_torch`` for the reference's jnp oracles."""
    ref, port = _public_names("repro"), _public_names("repro_torch")
    missing = [n for n in ref["core.__all__"] if n not in port["core"]]
    assert not missing, missing
    assert set(ref["core.__all__"]) <= set(port["core.__all__"])
    renamed = {"sum3d_pallas": "sum3d", "stencil3d_pallas": "stencil3d"}
    for mod in ("kernels.sum3d", "kernels.stencil3d", "kernels.tinymatsum", "kernels.matvec"):
        entry = [n for n in ref[mod] if n.endswith(("_pallas", "_mdspan", "_static", "_dynamic",
                                                       "_right", "_left"))]
        want = {renamed.get(n, n) for n in entry}
        assert want <= set(port[mod]), (mod, want - set(port[mod]))
    for name in ("sum3d", "matvec", "tinymatsum", "stencil3d"):
        assert name in ref["kernels.ops"] and name in port["kernels.ops"]
    for name in ("Int4SplitHalfAccessor", "MemorySpace", "HostTierAccessor"):
        assert name in port["core.accessors"]
    assert "layout_of_dense" in port["core.layouts"]


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
