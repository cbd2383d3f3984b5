#!/usr/bin/env python3
"""Where a serve run of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/profile_torch_serve.py [--out DIR]

Runs chip_smoke.py's serve workload (qwen2-0.5b in bf16 at full width and
depth, chunked prefill of 128 tokens, prefix sharing, max_batch 8, 16
requests of 32 new tokens) once more, after the same warm-up, and traces a
window of ACTIVE (8) decode steps with torch.profiler, starting after WAIT (40)
decode steps (the batch is full by then; chunk steps that fall inside the window
are traced too). The window is marked by wrapping the engine's step function
(``ServeEngine._step``) so that each decode step advances the profiler's
schedule; a whole run is too many events to parse in reasonable time.
Prints one JSON line: the window's span, device busy time by kernel class
(paged decode and chunk kernels, matmuls, copies, the rest), the device's
idle share of the window, and device kernels and host-side aten ops per
engine step (decode and chunk steps alike). The profiler's tables (by device time and by host time) go to DIR
(default chiprun_out/profile_serve). Profiling slows the host side, so step
times come from chip_smoke.py's unprofiled serve runs; device times here are
what the kernels took.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
WAIT, ACTIVE = 40, 8  # of the run's 80 decode steps: mid-run, batch full

CLASSES = (  # first match wins, on the kernel's name
    ("paged_decode", ("split_decode_kernel", "combine_splits_kernel")),
    ("paged_chunk", ("paged_chunk_kernel",)),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "sm90_", "splitk")),
    ("copy", ("memcpy", "memset", "copy_kernel", "catarray", "indexcopy", "index_put",
              "indexing_backward", "scatter", "gather", "index_elementwise")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def busy_union_us(spans) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, -float("inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "profile_serve"))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from torch.profiler import ProfilerActivity, profile, schedule

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    w = chip_smoke.serve_setup()
    eng = w.engine()
    reqs = w.requests()
    counts = {"decode": 0, "chunk": 0}
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=WAIT, warmup=1, active=ACTIVE, repeat=1),
                   acc_events=True)
    step, chunk_step = eng._step, eng._chunk_step

    def traced_step(*a, **k):
        out = step(*a, **k)
        torch.cuda.synchronize()
        counts["decode"] += 1
        prof.step()
        return out

    def traced_chunk_step(*a, **k):
        if WAIT + 1 <= counts["decode"] < WAIT + 1 + ACTIVE:
            counts["chunk"] += 1
        return chunk_step(*a, **k)

    eng._step, eng._chunk_step = traced_step, traced_chunk_step
    torch.cuda.synchronize()
    with prof:
        eng.run(reqs)
        torch.cuda.synchronize()
    m = eng.metrics()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    # device-side work; the profiler also puts each step's annotation
    # (ProfilerStep#n) on the device timeline, which is not work
    device_events = [e for e in events if getattr(e, "device_type", None) == cuda
                     and not e.name.startswith("ProfilerStep")]
    # aten ops the Python code dispatched (an op's own aten callees not counted)
    host_ops = [e for e in events if getattr(e, "device_type", None) != cuda
                and e.name.startswith("aten::")
                and not (e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::"))]
    by_class: dict = {}
    for e in device_events:
        cls = kernel_class(e.name)
        by_class[cls] = by_class.get(cls, 0.0) + e.time_range.elapsed_us()
    busy_us = busy_union_us([(e.time_range.start, e.time_range.end) for e in device_events])
    span_us = (max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
               if events else 0.0)
    n_steps = ACTIVE + counts["chunk"]  # engine steps in the window
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    for sort in ("self_device_time_total", "self_cpu_time_total"):
        try:
            table = prof.key_averages().table(sort_by=sort, row_limit=40)
        except (AttributeError, KeyError, ValueError):
            table = prof.key_averages().table(sort_by=sort.replace("device", "cuda"),
                                              row_limit=40)
        (out / f"by_{sort}.txt").write_text(table)
    rec = {
        "phase": "serve_profile", "nvidia_smi": smi,
        "window": {"after_decode_steps": WAIT, "decode_steps": ACTIVE,
                   "chunk_steps": counts["chunk"]},
        "span_ms": span_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1.0 - busy_us / span_us if span_us else None,
        "device_ms_by_class": {k: v / 1e3 for k, v in sorted(by_class.items())},
        "device_kernels": len(device_events), "aten_ops": len(host_ops),
        "device_ms_per_engine_step": busy_us / 1e3 / n_steps,
        "kernels_per_engine_step": len(device_events) / n_steps,
        "aten_ops_per_engine_step": len(host_ops) / n_steps,
        "run_decode_steps": m["decode_steps"], "tables": str(out),
    }
    print(json.dumps(rec), flush=True)
    if busy_us <= 0:
        print("profile_torch_serve: the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
