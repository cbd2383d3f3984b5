"""The trainer loop on a mesh and its elastic re-mesh, on 4 gloo ranks on
the CPU.

llama3.2 smoke in f32 (the loop's ``get_config`` patched to the f32 config) through ``TrainerLoop`` with ``model_axis`` 2: a (2, 2)
mesh over the 4 ranks, B 8 x 16, checkpoints every 2 steps. An unfailed run
of 10 steps first; then the same run with ``simulate_failure(at_step=5)``:
the ranks drop one model-axis row (4 -> 2 ranks; 8 divides the data axis of
1), ranks 2 and 3 leave the run cleanly, ranks 0 and 1 re-form a process
group of their own, rebuild the step on a (1, 2) mesh, restore the
committed step-4 checkpoint (written by the 4-rank mesh) onto it and finish
at step 10 with step 9 in the history. A checkpoint named step 4 holds the
state after step 4, and the run goes on from it with step 4's batch (the
port's restart rule, ROADMAP Queue 3), so the same run on one device with
the same failure is the measure: here, in the pytest process, the loop runs
without a process group, unfailed and failing at step 5, and each of its
losses is held against the mesh runs' (the unfailed 4-rank run's, and the
survivors' before and after the restore) within 1e-5 (the same function on
another split of the batch: f32 sums in another order, through up to ten
AdamW steps). Every step's history entry carries every rank's time (the
all-gather the heartbeats and the straggler policy read). The group's join
waits 120 s at most (``test_torch_multirank.spawn_group``).
"""
import dataclasses
import json
import sys
from pathlib import Path
from unittest import mock

import pytest
torch = pytest.importorskip("torch")

from test_torch_multirank import check_case, rank_main, spawn_group  # noqa: E402

RUN = dict(arch="llama3.2-1b", smoke=True, steps=10, batch=8, seq=16, ckpt_every=2,
           log_every=100, device="cpu", peak_lr=1e-3, warmup=2)
MODEL_AXIS = 2


def _f32_config(arch, smoke=False):
    from repro_torch.models import get_config

    return dataclasses.replace(get_config(arch, smoke=smoke), dtype="float32")


def _loop(workdir, name, fail_at=None, model_axis=MODEL_AXIS):
    from repro_torch.runtime import RunConfig, TrainerLoop, simulate_failure

    hook = simulate_failure(at_step=fail_at).maybe_fail if fail_at is not None else None
    with mock.patch("repro_torch.runtime.loop.get_config", _f32_config):
        loop = TrainerLoop(RunConfig(ckpt_dir=str(workdir / name), model_axis=model_axis, **RUN),
                           failure_hook=hook)
    return loop, loop.run_loop()


def _one_device(workdir):
    """The same runs without a process group: {"unfailed", "failing"}
    histories' losses."""
    torch.set_num_threads(2)
    return {name: [h["loss"] for h in _loop(workdir, f"one_{name}", fail, 1)[1]["history"]]
            for name, fail in (("unfailed", None), ("failing", 5))}


def case_unfailed_run(rank, workdir):
    loop, out = _loop(workdir, "unfailed")
    assert out["final_step"] == 10 and [h["step"] for h in out["history"]] == list(range(10))
    assert all(len(h["rank_times_s"]) == 4 for h in out["history"])
    assert not loop.monitor.dead_hosts() and loop.monitor.num_hosts == 4
    if rank == 0:
        (workdir / "unfailed.json").write_text(json.dumps([h["loss"] for h in out["history"]]))


def case_elastic_remesh(rank, workdir):
    loop, out = _loop(workdir, "failing", fail_at=5)
    if rank >= 2:
        assert out.get("left") and loop.left and out["final_step"] is None
        return
    hist = out["history"]
    assert loop.restarts == 1 and out["final_step"] == 10
    assert [h["step"] for h in hist] == [0, 1, 2, 3, 4, 4, 5, 6, 7, 8, 9]
    assert [h["world"] for h in hist] == [4] * 5 + [2] * 6
    assert all(len(h["rank_times_s"]) == h["world"] for h in hist)
    assert tuple(loop.mesh.shape) == (1, 2) and loop.monitor.num_hosts == 2
    unfailed = json.loads((workdir / "unfailed.json").read_text())
    for h in hist[:5]:  # before the failure: the same mesh, the same losses
        assert h["loss"] == unfailed[h["step"]], h
    if rank == 0:
        (workdir / "failing.json").write_text(json.dumps([h["loss"] for h in hist]))


CASES = {"unfailed_run": case_unfailed_run, "elastic_remesh": case_elastic_remesh}


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    workdir = tmp_path_factory.mktemp("elastic")
    return spawn_group(__file__, workdir, meanwhile=lambda: _one_device(workdir)), workdir


@pytest.mark.parametrize("case", list(CASES))
def test_trainer_loop_across_ranks(group, case):
    results, workdir = group
    check_case(results, case, workdir)


def test_every_rank_left_cleanly(group):
    results, _ = group
    assert results["_exit"] == [0, 0, 0, 0]


@pytest.mark.parametrize("run", ["unfailed", "failing"])
def test_mesh_losses_equal_the_one_device_loop(group, run):
    results, workdir = group
    check_case(results, "elastic_remesh" if run == "failing" else "unfailed_run", workdir)
    got = json.loads((workdir / f"{run}.json").read_text())
    want = results["_meanwhile"][run]
    assert len(got) == len(want) == (11 if run == "failing" else 10)
    for i, (a, b) in enumerate(zip(got, want)):
        assert abs(a - b) <= 1e-5 * abs(b), (run, i, a, b)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    rank_main(CASES)
