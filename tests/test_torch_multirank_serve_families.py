"""Serving on a mesh for the other families, on 4 gloo ranks on the CPU,
against the JAX package's one-device serving, with the harness and gates of
``test_torch_multirank_serve.py``: mamba2 smoke (the heads split over
"model": a head-split prefill that returns its final states, the head-split
decode on the state's heads and the conv cache gathered whole),
recurrentgemma smoke (the lru columns split; its window-8 ring wraps inside
the 12-token prompt, and its S-split ring decodes through the same local
step and merge) and kimi smoke (expert parallel on "model", capacity factor
8, and FSDP on "embed" over "data" as ``needs_fsdp_for_serving`` asks for
kimi-k2). The cross-attention families: ``_cross.py``.
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

ARCHS = ("mamba2", "rg", "kimi")
CASES = cases_of(ARCHS)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group(__file__, make_pairs(ARCHS),
                     tmp_path_factory.mktemp("multirank_serve_families"))


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_family_serve_runs_on_every_rank(group, case):
    results, workdir, _ = group
    check_case(results, case, workdir)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_family_serve_equals_the_references(group, arch, shape):
    check_serve(group, arch, shape)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    rank_main(CASES)
