"""TrainerLoop: the training run loop on one device (the port of
``repro.runtime.loop``): auto-resume, periodic and final checkpoints, the
straggler policy, and a restart after a failed step.

Flow of ``run_loop()``: model -> train_step -> [restore the latest
checkpoint] -> step loop {data, step, health, checkpoint} -> on a failed
step: rebuild the step, restore the latest committed checkpoint (or start
again from init when there is none) on the same device, and go on from
that checkpoint's step with its data. (The reference rebinds its pipeline
inside a ``for`` over the old one, so after a restart it goes on with the
steps after the failed one on the restored state.)

A restart is for a fault that goes away (the reference's lost node). A
step that fails again at or before the step of the last restart is a fault
that comes back, and is raised; so is a ``NotImplementedError``,
``ValueError`` or ``TypeError`` at once, as a refusal of the program that
no restart can cure (a kernel refusing its shapes, say). Every model family
trains here, on the card and on the CPU.

The reference re-meshes onto the surviving devices after a failure
(``loop.py:159-183``); that needs a mesh, which waits for ROADMAP item 6,
as do the per-host heartbeats (``health.HeartbeatMonitor``), which one
process beating for itself could never find silent. Here the restart stays
on the one device. Checkpoints hold {"params",
"opt"} in the reference's nesting (``models.bridge.to_reference_layout``),
so either package can resume the other's run.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Optional

import torch

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.tree import tree_map
from repro_torch.data import DataConfig, make_pipeline
from repro_torch.kernels.common import resolve_device
from repro_torch.models import build_model, from_jax_params, get_config, to_reference_layout
from repro_torch.optim import AdamWConfig, adamw_init, warmup_cosine
from repro_torch.optim.adamw import moment_spec
from repro_torch.train import TrainProfile, make_train_step

from .health import StragglerPolicy

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


class TrainerLoop:
    def __init__(self, run: RunConfig, failure_hook: Optional[Callable[[int], None]] = None):
        self.run = run
        self.device = resolve_device(run.device)
        self.failure_hook = failure_hook
        self.cfg = get_config(run.arch, smoke=run.smoke)
        self.model = build_model(self.cfg, device=self.device)
        self.ckpt = CheckpointManager(run.ckpt_dir, keep=3)
        self.history: List[Dict[str, float]] = []
        self.straggler = StragglerPolicy()
        self.restarts = 0
        self._build()

    # ------------------------------------------------------------------
    def _build(self):
        """(Re)build the train step."""
        self.opt = AdamWConfig(
            lr=warmup_cosine(self.run.peak_lr, self.run.warmup, self.run.steps),
            int8_state=self.run.int8_opt,
        )
        r = self.run
        profile = TrainProfile(num_microbatches=r.num_microbatches, accum_dtype=r.accum_dtype,
                               remat=r.remat, remat_policy=r.remat_policy)
        self.step_fn, self.param_specs, self.state_specs = make_train_step(
            self.model, self.opt, profile)

    def _init_state(self):
        params = self.model.init_params(torch.Generator(self.device).manual_seed(self.run.seed))
        return params, adamw_init(self.state_specs, self.device)

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
        return self.from_checkpoint(self.ckpt.restore(step, self._targets(), device="cpu"))

    # ------------------------------------------------------------------
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
                params, opt_state, start = self._restart()
                pipeline = make_pipeline(data_cfg, start_step=start, prefetch=False)
                continue
            dt = time.monotonic() - t0
            if self.straggler.observe(dt) == "rebalance":
                print(f"[loop] persistent straggler at step {step}; would re-mesh")
            self.history.append({"step": step, "loss": loss, "time_s": dt})
            if step % r.log_every == 0:
                print(f"[loop] step {step} loss {loss:.4f} ({dt * 1e3:.0f} ms)")
            if step > 0 and step % r.ckpt_every == 0:
                self.ckpt.save(step, self.to_checkpoint(params, opt_state))
        final = min(step + 1, r.steps)
        t0 = time.monotonic()
        self.ckpt.save(final, self.to_checkpoint(params, opt_state))
        self.ckpt.wait()
        written = self.ckpt.dir / f"step_{final:08d}"
        self.last_save = {"step": final, "seconds": time.monotonic() - t0,
                          "bytes": sum(f.stat().st_size for f in written.iterdir())}
        self.params, self.opt_state = params, opt_state
        return {"history": self.history, "final_step": final}

    # ------------------------------------------------------------------
    def _restart(self):
        """After a failed step: rebuild the step and restore the latest
        committed checkpoint on the same device (an in-flight save is let
        finish first), or start again from init when there is none."""
        self.failure_hook = None  # the failed node is gone, not failing again
        self.restarts += 1
        self.ckpt.wait()
        self._build()
        latest = self.ckpt.latest()
        if latest is None:
            params, opt_state = self._init_state()
            return params, opt_state, 0
        params, opt_state = self.restore(latest)
        return params, opt_state, latest
