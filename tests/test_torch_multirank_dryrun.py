"""The dry run's fake trace against a real run: one smoke train cell
(llama3.2, ``train_rules``) and one smoke decode cell (kimi-k2, ``serve_rules``:
the expert-parallel block) run on 4 gloo ranks at (2, 2), each rank's step
once under ``core.distributed.CollectiveCounter`` and once under the dry
run's ``StepTracer``. Rank 0's collectives (calls and bytes by op, from both),
flops and peak of live bytes equal those of the same cells
traced by ``launch.dryrun`` as rank 0 of a fake world of 4 ranks under
``FakeTensorMode`` (run beside the ranks, in its own process); the bytes
accessed too, but for two named departures of the real run (gloo's
reduce-scatter copies, eager one_hot's validation). The
``CollectiveCounter`` sees fewer calls than the tracer on the train cell: it
misses the redistributions DTensor runs inside an op's dispatch.
"""
import json
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

from test_torch_multirank import check_case, mesh_of, rank_main, spawn_group  # noqa: E402

MESH = (2, 2)
CELLS = {"train": ("llama3.2-1b", "train", 32, 8), "decode": ("kimi-k2-1t-a32b", "decode", 32, 4)}


def _build(cell, mesh):
    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun as dr
    from repro_torch.models import get_config

    arch, kind, seq, batch = CELLS[cell]
    return dr.build_cell(arch, Shape(f"smoke_{kind}", kind, seq, batch), mesh,
                         cfg_override=get_config(arch, smoke=True))


def _measure(fn, args, make_args):
    """(CollectiveCounter's calls and bytes, the tracer's) of one step each."""
    from repro_torch.core.distributed import CollectiveCounter
    from repro_torch.launch import dryrun as dr

    with CollectiveCounter() as c:
        fn(*args)
    args = make_args()
    tracer = dr.StepTracer(args)
    with tracer:
        fn(*args)
    return {"counter": {"calls": c.calls, "bytes": c.bytes},
            "tracer": {"calls": tracer.counter.calls, "bytes": tracer.counter.bytes,
                       "flops": tracer.flops, "bytes_accessed": tracer.bytes_accessed,
                       "peak_temp": tracer.peak_temp}}


def _case(cell):
    def run(rank, workdir):
        mesh = mesh_of(MESH)
        fn, args, _ = _build(cell, mesh)
        rec = _measure(fn, args, lambda: _build(cell, mesh)[1])
        if rank == 0:
            (workdir / f"real_{cell}.json").write_text(json.dumps(rec))

    return run


CASES = {f"real_{c}": _case(c) for c in CELLS}


def fake_side(workdir: Path) -> None:
    """The same cells traced by the dry run: rank 0 of a fake world of 4."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch import dryrun as dr

    torch.set_num_threads(1)
    with dr.fake_world(4):
        mesh = dr.make_mesh(False, MESH)
        for cell in CELLS:
            with FakeTensorMode(allow_non_fake_inputs=True):
                fn, args, _ = _build(cell, mesh)
                rec = _measure(fn, args, lambda: _build(cell, mesh)[1])
            (workdir / f"fake_{cell}.json").write_text(json.dumps(rec))
    print("FAKE-SIDE-OK")


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("multirank_dryrun")
    side = [sys.executable, __file__, "--fake-side", str(workdir)]
    return spawn_group(__file__, workdir, side=side), workdir


@pytest.mark.parametrize("cell", list(CELLS))
def test_fake_trace_equals_the_real_ranks(group, cell):
    results, workdir = group
    check_case(results, f"real_{cell}", workdir)
    side = results.get("_side", {})
    assert side.get("exit") == 0, side.get("output")
    real = json.loads((workdir / f"real_{cell}.json").read_text())
    fake = json.loads((workdir / f"fake_{cell}.json").read_text())
    moved = {k: v for k, v in real["tracer"].items() if k != "bytes_accessed"}
    assert {**fake, "tracer": {k: v for k, v in fake["tracer"].items()
                               if k != "bytes_accessed"}} == {**real, "tracer": moved}
    got, want = fake["tracer"]["bytes_accessed"], real["tracer"]["bytes_accessed"]
    if cell == "train":
        # gloo's reduce-scatter splits its input and copies the chunks with
        # aten ops the tracer sees (split, copy_: each call's input and
        # output once); the fake backend, like NCCL, runs none
        assert want - got == real["counter"]["bytes"]["_reduce_scatter_base_"], (want, got)
    else:
        # eager validates F.one_hot's ids (an aminmax: the MoE routing),
        # which FakeTensorMode decomposes otherwise
        assert got == pytest.approx(want, rel=1e-3, abs=0)
    assert real["tracer"]["calls"], real  # the cell runs collectives
    if cell == "train":  # the counter misses what DTensor's dispatch runs
        assert sum(real["counter"]["calls"].values()) < sum(real["tracer"]["calls"].values())


if __name__ == "__main__":
    if sys.argv[1] == "--fake-side":
        fake_side(Path(sys.argv[2]))
    else:
        rank_main(CASES)
