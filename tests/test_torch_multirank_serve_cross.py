"""Serving on a mesh for the cross-attention families, on 4 gloo ranks on
the CPU, against the JAX package's one-device serving, with the harness and
gates of
``test_torch_multirank_serve.py``: whisper smoke (the encoder on the mesh,
the cross caches' 12 frames split over "model", the cross decode merged like
the self decode) and the vision smoke model (one group of 4 self layers and
the gated cross layer, gate 0.7, 8 image tokens split over "model").
"""
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from test_torch_multirank import check_case, rank_main  # noqa: E402
from test_torch_multirank_serve import (  # noqa: E402
    MESHES,
    cases_of,
    check_serve,
    make_pairs,
    run_group,
)

ARCHS = ("whisper", "vision")
CASES = cases_of(ARCHS)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group(__file__, make_pairs(ARCHS),
                     tmp_path_factory.mktemp("multirank_serve_cross"))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_cross_serve_runs_on_every_rank(group, case):
    results, workdir, _ = group
    check_case(results, case, workdir)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_cross_serve_equals_the_references(group, arch, shape):
    check_serve(group, arch, shape)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    rank_main(CASES)
