"""TrainerLoop: the training run loop (the port of ``repro.runtime.loop``):
auto-resume, periodic and final checkpoints, heartbeats and the straggler
policy, and a restart after a failed step.

Flow of ``run_loop()``: [mesh] -> model -> train_step -> [restore the latest
checkpoint] -> step loop {data, step, health, checkpoint} -> on a failed
step: rebuild the step, restore the latest committed checkpoint (or start
again from init when there is none), and go on from that checkpoint's step
with its data. (The reference rebinds its pipeline inside a ``for`` over
the old one, so after a restart it goes on with the steps after the failed
one on the restored state.)

Where a ``torch.distributed`` process group is up, the loop runs on a
("data", "model") mesh over its ranks, ``RunConfig.model_axis`` wide
(``launch.make_host_mesh``, ``launch.train_rules``): every rank builds the
same global batch and the step shards it. Each step's time is all-gathered,
so the ``HeartbeatMonitor`` hears every rank and the straggler policy sees
the slowest. After a failed step the run re-meshes elastically, as the
reference's ``_surviving_devices``: one model-axis row of ranks is dropped
at a time until the global batch divides the data axis; the dropped ranks
leave the run (``run_loop`` returns with ``"left": True``), the survivors
re-form a process group of their own on a fresh file store beside the
checkpoints, rebuild the step and restore the latest committed checkpoint
onto the smaller mesh. Without a process group the loop runs on one device
and a restart stays there.

A restart is for a fault that goes away (the reference's lost node). A
step that fails again at or before the step of the last restart is a fault
that comes back, and is raised; so is a ``NotImplementedError``,
``ValueError`` or ``TypeError`` at once, as a refusal of the program that
no restart can cure (a kernel refusing its shapes, say). Checkpoints hold
{"params", "opt"} in the reference's nesting
(``models.bridge.to_reference_layout``), so either package can resume the
other's run.
"""
from __future__ import annotations

import dataclasses
import time
import uuid
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.store import is_writer
from repro_torch.core.distributed import tree_distribute
from repro_torch.core.tree import tree_map
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.launch import make_host_mesh, train_rules
from repro_torch.models import build_model, from_jax_params, get_config, to_reference_layout
from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
from repro_torch.optim.adamw import moment_spec
from repro_torch.train import TrainProfile, make_train_step

from .health import HeartbeatMonitor, StragglerPolicy

# faults a restart cannot cure: the program refusing its input or its device
NOT_RESTARTED = (NotImplementedError, ValueError, TypeError)


def _moment_storage(spec, shape, device):
    """Empty storage of a moment of ``shape``: f32, or int8 ``q`` and f32
    per-block ``scale`` when ``spec`` is quantized."""
    if not spec.is_quantized():
        return torch.empty(shape, dtype=torch.float32, device=device)
    *lead, last = shape
    return {"q": torch.empty(shape, dtype=torch.int8, device=device),
            "scale": torch.empty((*lead, last // spec.quant.block), dtype=torch.float32,
                                 device=device)}


@dataclasses.dataclass
class RunConfig:
    arch: str = "llama3.2-1b"
    smoke: bool = True
    steps: int = 100
    batch: int = 8
    seq: int = 64
    peak_lr: float = 1e-3
    warmup: int = 20
    ckpt_dir: str = "checkpoints/run"
    ckpt_every: int = 25
    log_every: int = 10
    seed: int = 0
    num_microbatches: int = 1
    remat: bool = True
    remat_policy: Optional[str] = None  # None | "nothing" | "dots" (TrainProfile)
    accum_dtype: torch.dtype = torch.float32  # the microbatches' gradient sum
    int8_opt: bool = False
    resume: bool = True
    device: Optional[str] = None  # None: CUDA, as every entry point of the port
    model_axis: int = 1  # the mesh's "model" width, where a process group is up
    final_save: bool = True  # checkpoint the last step (off: a timed run that keeps nothing)


def _dist():
    import torch.distributed as dist

    return dist if dist.is_available() and dist.is_initialized() else None


class TrainerLoop:
    def __init__(self, run: RunConfig, failure_hook: Optional[Callable[[int], None]] = None):
        self.run = run
        self.device = resolve_device(run.device)
        self.failure_hook = failure_hook
        self.cfg = get_config(run.arch, smoke=run.smoke)
        self.model = build_model(self.cfg, device=self.device)
        self.ckpt = CheckpointManager(run.ckpt_dir, keep=3)
        self.history: List[Dict[str, float]] = []
        self.last_save: Optional[Dict[str, Any]] = None  # the final save's step, seconds, bytes
        self.straggler = StragglerPolicy()
        self.restarts = 0
        self.left = False
        self.mesh = self.rules = None
        if _dist() is not None:
            self.mesh = make_host_mesh(run.model_axis, self.device.type)
            self.rules = train_rules(self.cfg)
        elif run.model_axis != 1:
            raise ValueError(f"model_axis {run.model_axis} needs a torch.distributed process "
                             "group (one rank a device)")
        self._build()

    @property
    def world(self) -> int:
        return _dist().get_world_size() if _dist() is not None else 1

    # ------------------------------------------------------------------
    def _build(self):
        """(Re)build the train step (on the current mesh, if any) and the
        heartbeat monitor of its ranks."""
        self.opt = AdamWConfig(
            lr=warmup_cosine(self.run.peak_lr, self.run.warmup, self.run.steps),
            int8_state=self.run.int8_opt,
        )
        r = self.run
        if self.mesh is not None and r.batch % (self.world // r.model_axis):
            raise ValueError(f"the global batch {r.batch} does not divide the data axis of "
                             f"{self.world // r.model_axis} ranks")
        profile = TrainProfile(num_microbatches=r.num_microbatches, accum_dtype=r.accum_dtype,
                               remat=r.remat, remat_policy=r.remat_policy)
        self.step_fn, self.param_specs, self.state_specs = make_train_step(
            self.model, self.opt, profile, mesh=self.mesh, rules=self.rules)
        self.monitor = HeartbeatMonitor(num_hosts=self.world, timeout_s=300)

    def _place(self, params, opt_state):
        """A state every rank holds whole, laid onto the mesh (as it is
        without one)."""
        if self.mesh is None:
            return params, opt_state
        moments = {k: tree_distribute(opt_state[k], self.state_specs[k], self.mesh, self.rules)
                   for k in ("m", "v")}
        return (tree_distribute(params, self.param_specs, self.mesh, self.rules),
                dict(moments, step=opt_state["step"]))

    def _init_state(self):
        params = self.model.init_params(torch.Generator(self.device).manual_seed(self.run.seed))
        if self.mesh is not None:
            params = tree_distribute(params, self.param_specs, self.mesh, self.rules)
        return params, adamw_init(self.state_specs, self.device, self.mesh, self.rules)

    def to_checkpoint(self, params, opt_state, device="cpu"):
        """{"params", "opt"} in the reference's nesting (on the host by
        default)."""
        def ref(tree, **kw):
            return to_reference_layout(tree, self.cfg, device=device, **kw)

        step = opt_state["step"].detach()
        return {"params": ref(params),
                "opt": {"m": ref(opt_state["m"], empty=self._empty_moment),
                        "v": ref(opt_state["v"], empty=self._empty_moment),
                        "step": step.to(device) if device is not None else step}}

    def _save(self, step: int, params, opt_state):
        """Every rank joins ``to_checkpoint``'s gathers; only the writer (rank
        0) copies the whole tree to the host, the others keep its shapes."""
        tree = self.to_checkpoint(params, opt_state, device="cpu" if is_writer() else "meta")
        self.ckpt.save(step, tree)

    def _empty_moment(self, spec):
        """A zero-count program entry's moment leaf (the reference keeps an
        empty stack there), quantized where the int8 rule says so."""
        return _moment_storage(moment_spec(spec, (0,) + tuple(spec.shape), self.opt),
                               (0,) + tuple(spec.shape), "cpu")

    def _targets(self):
        """The checkpoint's structure as meta tensors (shapes and dtypes only)."""
        params = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"),
                          self.param_specs)
        moments = tree_map(lambda s: _moment_storage(s, s.shape, "meta"), self.state_specs["m"])
        state = {"m": moments, "v": moments,
                 "step": torch.empty((), dtype=torch.int32, device="meta")}
        return self.to_checkpoint(params, state, device=None)

    def from_checkpoint(self, tree):
        """``to_checkpoint``'s inverse, onto this loop's device."""
        opt = tree["opt"]
        return (from_jax_params(tree["params"], self.cfg, device=self.device),
                {"m": from_jax_params(opt["m"], self.cfg, device=self.device),
                 "v": from_jax_params(opt["v"], self.cfg, device=self.device),
                 "step": opt["step"].to(self.device)})

    def restore(self, step: int):
        """Checkpoint ``step`` on this loop's device, laid onto its mesh (every
        rank reads it whole)."""
        return self._place(*self.from_checkpoint(
            self.ckpt.restore(step, self._targets(), device="cpu")))

    # ------------------------------------------------------------------
    def _barrier(self):
        if _dist() is not None:
            _dist().barrier()

    def _rank_times(self, dt: float) -> List[float]:
        """Every rank's time of this step (an all-gather), beating each."""
        d = _dist()
        if d is None:
            times = [dt]
        else:
            mine = torch.tensor([dt], dtype=torch.float64, device=self.device)
            every = torch.empty(self.world, dtype=torch.float64, device=self.device)
            d.all_gather_into_tensor(every, mine)
            times = every.tolist()
        for r in range(len(times)):
            self.monitor.beat(r)
        return times

    def run_loop(self) -> Dict[str, Any]:
        r = self.run
        data_cfg = DataConfig(batch=r.batch, seq=r.seq, vocab=self.cfg.vocab, seed=r.seed)
        start = 0
        params = opt_state = None
        if r.resume and self.ckpt.latest() is not None:
            start = self.ckpt.latest()
            params, opt_state = self.restore(start)
            print(f"[loop] resumed from step {start}")
        if params is None:
            params, opt_state = self._init_state()

        pipeline = make_pipeline(data_cfg, start_step=start, prefetch=False)
        step, failed_at = start, None
        while True:
            step, batch = next(pipeline)
            if step >= r.steps:
                break
            t0 = time.monotonic()
            try:
                if self.failure_hook is not None:
                    self.failure_hook(step)
                batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
                params, opt_state, metrics = self.step_fn(params, opt_state, batch)
                loss = float(metrics["loss"])
            except NOT_RESTARTED:
                raise
            except Exception as e:
                if failed_at is not None and step <= failed_at:
                    raise RuntimeError(f"step {step} failed again after the restart at step "
                                       f"{failed_at}: not restarting") from e
                failed_at = step
                print(f"[loop] step {step} failed ({e}); restart")
                restarted = self._restart()
                if restarted is None:  # this rank was dropped from the smaller mesh
                    self.left = True
                    return {"history": self.history, "final_step": None, "left": True}
                params, opt_state, start = restarted
                pipeline = make_pipeline(data_cfg, start_step=start, prefetch=False)
                continue
            dt = time.monotonic() - t0
            times = self._rank_times(dt)
            if self.straggler.observe(max(times)) == "rebalance":
                print(f"[loop] persistent straggler at step {step}; would re-mesh")
            self.history.append({"step": step, "loss": loss, "time_s": dt,
                                 "rank_times_s": times, "world": self.world})
            if step % r.log_every == 0:
                print(f"[loop] step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            if step > 0 and step % r.ckpt_every == 0:
                self._save(step, params, opt_state)
        final = min(step + 1, r.steps)
        if r.final_save:
            t0 = time.monotonic()
            self._save(final, params, opt_state)
            self.ckpt.wait()
            self._barrier()
            written = self.ckpt.dir / f"step_{final:08d}"
            self.last_save = {"step": final, "seconds": time.monotonic() - t0,
                              "bytes": sum(f.stat().st_size for f in written.iterdir())}
        self.params, self.opt_state = params, opt_state
        return {"history": self.history, "final_step": final}

    # ------------------------------------------------------------------
    def _surviving_ranks(self) -> int:
        """How many ranks stay: one model-axis row fewer, and more rows off
        until the global batch divides the data axis (the reference's
        ``_surviving_devices``)."""
        m = self.run.model_axis
        keep = self.world - m
        while keep // m > 0 and self.run.batch % (keep // m):
            keep -= m
        if keep < m:
            raise RuntimeError(f"no viable surviving mesh below {self.world} ranks")
        return keep

    def _remesh(self) -> bool:
        """Drop the ranks past ``_surviving_ranks`` and re-form the rest on a
        fresh file store beside the checkpoints; False on a dropped rank
        (its process group is gone)."""
        d = _dist()
        keep, rank, backend = self._surviving_ranks(), d.get_rank(), d.get_backend()
        nonce = [uuid.uuid4().hex if rank == 0 else None]
        d.broadcast_object_list(nonce, src=0)
        store = self.ckpt.dir / f".remesh-{nonce[0]}"
        d.destroy_process_group()
        if rank >= keep:
            print(f"[loop] rank {rank} leaves the run")
            return False
        print(f"[loop] re-meshing onto {keep} ranks")
        d.init_process_group(backend, init_method=f"file://{store}", world_size=keep, rank=rank)
        self.mesh = make_host_mesh(self.run.model_axis, self.device.type)
        return True

    def _restart(self):
        """After a failed step: re-mesh onto the surviving ranks (on a mesh)
        or stay on the device, rebuild the step, and restore the latest
        committed checkpoint (an in-flight save is let finish first), or
        start again from init when there is none. None on a dropped rank."""
        self.failure_hook = None  # the failed node is gone, not failing again
        self.restarts += 1
        self.ckpt.wait()
        self._barrier()
        if self.mesh is not None and not self._remesh():
            return None
        self._build()
        latest = self.ckpt.latest()
        if latest is None:
            params, opt_state = self._init_state()
            return params, opt_state, 0
        params, opt_state = self.restore(latest)
        return params, opt_state, latest
