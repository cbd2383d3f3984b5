#!/usr/bin/env python3
"""The sharded train step against the one-device step of one tree, on one GPU.

    python3 scripts/time_sharded_step.py --tree DIR --label NAME [--arch NAME]
        [--steps N] [--trace N]

Imports ``chip_smoke`` and ``repro_torch`` from DIR (a checkout, or a
``git archive`` of another commit unpacked under a git-ignored directory),
so two trees are compared in one call: run parent, change, change, parent.
For ``chip_smoke.TRAIN_CELLS[NAME]`` (default llama3.2-1b: full width, bf16
params, remat, f32 moments, B 4 x 2048) it builds the one-device step
(``TrainerLoop``) and then the sharded one (``TrainerLoop(model_axis=
chip_smoke.SHARDED_W)`` under ``chip_smoke.process_group``: a (1, 1) mesh,
``train_rules``), and for each: 2 warm-up steps, N (6) timed steps on
SyntheticLM batches (synchronised wall ms: the p50), one step counted (the
ops dispatched on DTensors and DTensor's redistributions: a counter of its
own here, so it counts a tree without ``core.distributed.DispatchCounter``
alike), then N (2) steps traced with torch.profiler: the device's busy ms a
step and idle share of the traced span, and the host's self time a step of
DTensor's Python dispatch (``PythonSubclass``) and of ``Redistribute``.
Prints one JSON line with the card's name and power limit, the two p50s and
their ratio.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import statistics
import sys
import tempfile
import time
from pathlib import Path

import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from profile_torch_serve import busy_union_us  # noqa: E402


class _Counts:
    """DTensor op dispatches (ops with a DTensor argument) and calls of
    DTensor's ``redistribute_local_tensor``, while entered."""

    MODULES = ("_api", "_dispatch", "_redistribute")

    def __init__(self):
        self.ops = 0
        self.redistributions = 0

    def __enter__(self):
        import importlib

        from torch.distributed.tensor import DTensor
        from torch.utils._python_dispatch import TorchDispatchMode

        counts = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                flat = []
                for a in list(args) + list(kwargs.values()):
                    flat.extend(a if isinstance(a, (list, tuple)) else [a])
                if any(isinstance(a, DTensor) for a in flat):
                    counts.ops += 1
                return func(*args, **kwargs)

        self._saved = []
        for name in self.MODULES:
            mod = importlib.import_module(f"torch.distributed.tensor.{name}")
            orig = mod.redistribute_local_tensor

            def counted(*a, _orig=orig, **kw):
                counts.redistributions += 1
                return _orig(*a, **kw)

            self._saved.append((mod, orig))
            mod.redistribute_local_tensor = counted
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        for mod, orig in self._saved:
            mod.redistribute_local_tensor = orig
        return False


def _run(chip_smoke, arch, cell, sharded: bool, steps: int, trace: int):
    from repro_torch.runtime import RunConfig, TrainerLoop
    from torch.profiler import ProfilerActivity, profile

    warmup = 2
    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop = TrainerLoop(RunConfig(arch=arch, smoke=False, steps=1, batch=cell["batch"],
                                     seq=cell["seq"], peak_lr=3e-4, warmup=2,
                                     ckpt_dir=ckpt_dir, remat=True, device="cuda",
                                     model_axis=chip_smoke.SHARDED_W if sharded else 1))
    params, state = loop._init_state()
    batches = [chip_smoke._train_batch(loop.cfg, cell["batch"], cell["seq"], "cuda", seed=i)
               for i in range(4)]
    for i in range(warmup):
        params, state, _ = loop.step_fn(params, state, batches[i % 4])
    torch.cuda.synchronize()
    times = []
    for i in range(steps):
        t0 = time.perf_counter()
        params, state, _ = loop.step_fn(params, state, batches[i % 4])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _Counts()
    with counts:
        params, state, _ = loop.step_fn(params, state, batches[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(trace):
            params, state, _ = loop.step_fn(params, state, batches[i % 4])
            torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if getattr(e, "device_type", None) == cuda]
    busy = busy_union_us([(e.time_range.start, e.time_range.end) for e in dev])
    span = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
            if events else 0.0)
    host = {}
    for e in prof.key_averages():
        if e.key in ("PythonSubclass", "Redistribute") or "redistribute" in e.key.lower():
            host[e.key] = [e.self_cpu_time_total / 1e3 / trace, e.count / trace]
    mesh = list(loop.mesh.shape) if loop.mesh is not None else None
    del loop, params, state
    torch.cuda.empty_cache()
    return {"mesh": mesh, "step_ms": times, "step_ms_p50": statistics.median(times),
            "dtensor_op_dispatches_per_step": counts.ops,
            "redistributions_per_step": counts.redistributions,
            "traced_steps": trace, "device_busy_ms_per_step": busy / 1e3 / trace,
            "device_idle_share": 1.0 - busy / span if span else None,
            "host_self_ms_and_calls_per_step": host}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--arch", default="llama3.2-1b")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--trace", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_sharded_step: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree), str(tree / "src")]
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = chip_smoke.TRAIN_CELLS[args.arch]
    one = _run(chip_smoke, args.arch, cell, False, args.steps, args.trace)
    with chip_smoke.process_group("cuda") if chip_smoke.SHARDED_W == 1 else \
            contextlib.nullcontext():
        sharded = _run(chip_smoke, args.arch, cell, True, args.steps, args.trace)
    print(json.dumps({"phase": "time_sharded_step", "label": args.label, "tree": str(tree),
                      "nvidia_smi": chip_smoke.nvidia_smi_line(), "arch": args.arch,
                      "batch": cell["batch"], "seq": cell["seq"], "one_device": one,
                      "sharded": sharded,
                      "sharded_over_one_device": sharded["step_ms_p50"] / one["step_ms_p50"]}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
