"""The sharded train step of llama3.2 smoke (f32) with int8 AdamW moments
(quant block 16: ``test_torch_multirank_step.INT8_ARCHS``) on 4 gloo ranks
on the CPU, on (2, 2), (4, 1) and (1, 4) meshes, against the port's
one-device step and the JAX package's single-device step, both with int8
moments: each moment's {"q", "scale"} laid out as the quantized leaf's
placements and encoded on each rank's shard. The harness and the gates:
``test_torch_multirank_step.py``.
"""
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from test_torch_multirank import check_case, rank_main  # noqa: E402
from test_torch_multirank_step import (  # noqa: E402
    MESHES,
    cases_of,
    check_step,
    make_pairs,
    run_group,
)

ARCHS = ("llama_int8",)
CASES = cases_of(ARCHS)


@pytest.fixture(scope="module")
def pairs():
    return make_pairs(ARCHS)


@pytest.fixture(scope="module")
def group(pairs, tmp_path_factory):
    return run_group(__file__, pairs, tmp_path_factory.mktemp("multirank_step_int8"))


@pytest.fixture(scope="module")
def references(group):
    return group[2]


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_int8_step_runs_on_every_rank(group, case):
    results, workdir, _ = group
    check_case(results, case, workdir)


@pytest.mark.parametrize("against", ["port", "jax"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_int8_step_equals_the_one_device_steps(group, references, arch, shape,
                                                       against):
    check_step(group, references, arch, shape, against)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    rank_main(CASES)
