"""The port's runtime (repro_torch.runtime) on the CPU, with the reference's
tests/test_runtime.py assertions: the trainer loop learns and checkpoints,
resumes from its checkpoint, and survives a failure (on one device: the
reference's re-mesh onto fewer devices waits for distribution, so the
device-count assertion is the one left out); a fault that comes back after
the restart, and a refusal of the program, are raised instead of restarted
for ever; the heartbeat and straggler primitives behave."""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.runtime import (  # noqa: E402
    HeartbeatMonitor,
    RunConfig,
    StragglerPolicy,
    TrainerLoop,
    simulate_failure,
)


def test_heartbeat_monitor():
    clock = [0.0]
    mon = HeartbeatMonitor(num_hosts=3, timeout_s=10, clock=lambda: clock[0])
    clock[0] = 5.0
    mon.beat(0)
    mon.beat(1)
    clock[0] = 12.0
    assert mon.dead_hosts() == [2]
    mon.beat(2)
    assert mon.all_alive()


def test_straggler_policy_escalates():
    p = StragglerPolicy(threshold=2.0, patience=2)
    assert p.observe(1.0) == "ok"
    assert p.observe(1.0) == "ok"
    assert p.observe(5.0) == "straggle"
    assert p.observe(5.0) == "rebalance"
    assert p.observe(1.0) == "ok"  # recovered


def test_simulate_failure_raises_at_its_step():
    f = simulate_failure(at_step=3, exc=ValueError("x"))
    f.maybe_fail(2)
    with pytest.raises(ValueError):
        f.maybe_fail(3)


def test_trainer_loop_learns_and_checkpoints(tmp_path):
    run = RunConfig(
        arch="llama3.2-1b", smoke=True, steps=12, batch=4, seq=32,
        peak_lr=3e-3, warmup=2, ckpt_dir=str(tmp_path), ckpt_every=5, log_every=50,
        device="cpu",
    )
    loop = TrainerLoop(run)
    out = loop.run_loop()
    hist = out["history"]
    assert len(hist) == 12
    first = np.mean([h["loss"] for h in hist[:3]])
    last = np.mean([h["loss"] for h in hist[-3:]])
    assert last < first, (first, last)  # synthetic data has learnable structure
    assert loop.ckpt.latest() == 12


def test_trainer_loop_resumes_from_checkpoint(tmp_path):
    run = RunConfig(arch="qwen2-0.5b", smoke=True, steps=6, batch=4, seq=16,
                    ckpt_dir=str(tmp_path), ckpt_every=3, log_every=50, device="cpu")
    TrainerLoop(run).run_loop()
    # second run continues (resume=True): starts from committed step 6
    run2 = RunConfig(arch="qwen2-0.5b", smoke=True, steps=8, batch=4, seq=16,
                     ckpt_dir=str(tmp_path), ckpt_every=3, log_every=50, device="cpu")
    out = TrainerLoop(run2).run_loop()
    steps_run = [h["step"] for h in out["history"]]
    assert steps_run and steps_run[0] >= 6, steps_run


@pytest.mark.parametrize("int8", [False, True], ids=["f32_moments", "int8_moments"])
def test_trainer_loop_restarts_on_failure(tmp_path, int8):
    run = RunConfig(arch="llama3.2-1b", smoke=True, steps=10, batch=4, seq=16,
                    ckpt_dir=str(tmp_path), ckpt_every=2, log_every=50, device="cpu",
                    int8_opt=int8)
    fail = simulate_failure(at_step=5)
    loop = TrainerLoop(run, failure_hook=fail.maybe_fail)
    out = loop.run_loop()
    assert loop.restarts == 1
    assert out["final_step"] == 10
    assert any(h["step"] == 9 for h in out["history"])  # finished after restart
    steps = [h["step"] for h in out["history"]]
    assert steps == [0, 1, 2, 3, 4, 4, 5, 6, 7, 8, 9]  # again from the step-4 checkpoint


def test_trainer_loop_restarts_from_init_without_a_checkpoint(tmp_path):
    run = RunConfig(arch="llama3.2-1b", smoke=True, steps=4, batch=2, seq=16,
                    ckpt_dir=str(tmp_path), ckpt_every=100, log_every=50, device="cpu")
    loop = TrainerLoop(run, failure_hook=simulate_failure(at_step=2).maybe_fail)
    out = loop.run_loop()
    assert [h["step"] for h in out["history"]] == [0, 1, 0, 1, 2, 3]
    assert out["history"][0]["loss"] == out["history"][2]["loss"]  # the same init, same data


def _faulty_steps(monkeypatch, fault):
    """Make every train step that TrainerLoop builds call ``fault(n)`` first,
    ``n`` the updates its opt state holds."""
    import repro_torch.runtime.loop as loop_mod

    real = loop_mod.make_train_step

    def make(*args, **kw):
        step_fn, param_specs, state_specs = real(*args, **kw)

        def faulty(params, opt_state, batch):
            fault(int(opt_state["step"]))
            return step_fn(params, opt_state, batch)

        return faulty, param_specs, state_specs

    monkeypatch.setattr(loop_mod, "make_train_step", make)


@pytest.mark.parametrize("fails_at", ["every_step", "update_3"])
def test_trainer_loop_raises_a_fault_that_comes_back(tmp_path, monkeypatch, fails_at):
    """A fault that a restart does not cure (on every step; or on the fourth
    update, at step 3 and again at step 2 after the restore of the
    checkpoint taken after step 2) is raised after one restart, not
    restarted forever."""
    def fault(n):
        if fails_at == "every_step" or n == 3:
            raise RuntimeError("kernel launch failed")

    _faulty_steps(monkeypatch, fault)
    run = RunConfig(arch="llama3.2-1b", smoke=True, steps=6, batch=2, seq=8,
                    ckpt_dir=str(tmp_path), ckpt_every=2, log_every=50, device="cpu")
    loop = TrainerLoop(run)
    with pytest.raises(RuntimeError, match="failed again") as info:
        loop.run_loop()
    assert loop.restarts == 1
    assert "kernel launch failed" in str(info.value.__cause__)
    assert [h["step"] for h in loop.history] == ([] if fails_at == "every_step" else [0, 1, 2])


@pytest.mark.parametrize("exc", [NotImplementedError, ValueError, TypeError])
def test_trainer_loop_raises_a_refusal_without_restart(tmp_path, monkeypatch, exc):
    def fault(n):
        if n == 1:
            raise exc("not on this device")

    _faulty_steps(monkeypatch, fault)
    run = RunConfig(arch="llama3.2-1b", smoke=True, steps=4, batch=2, seq=8,
                    ckpt_dir=str(tmp_path), ckpt_every=100, log_every=50, device="cpu")
    loop = TrainerLoop(run)
    with pytest.raises(exc, match="not on this device"):
        loop.run_loop()
    assert loop.restarts == 0
    assert [h["step"] for h in loop.history] == [0]


def test_trainer_loop_takes_the_profile_from_its_run_config(tmp_path):
    run = RunConfig(arch="llama3.2-1b", smoke=True, steps=1, batch=2, seq=8,
                    ckpt_dir=str(tmp_path), remat=True, remat_policy="dots",
                    accum_dtype=torch.bfloat16, num_microbatches=2, device="cpu")
    loop = TrainerLoop(run)
    out = loop.run_loop()
    assert out["final_step"] == 1 and np.isfinite(out["history"][0]["loss"])
