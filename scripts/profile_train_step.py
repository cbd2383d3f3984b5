#!/usr/bin/env python3
"""Where a train step of the PyTorch/CUDA port spends its time, on one GPU.

    python3 scripts/profile_train_step.py [--arch NAME] [--steps N] [--out DIR] [--sharded]

Builds chip_smoke.py's train cell for NAME (``TRAIN_CELLS``: llama3.2-1b,
mamba2-780m or recurrentgemma-2b at full width, bf16 params, remat, f32
AdamW moments, the cell's batch and sequence) through ``TrainerLoop``'s own train
step, runs two warm-up steps on SyntheticLM batches, then traces N (2) steps
with torch.profiler. With ``--sharded`` the step is the sharded one
(``make_train_step(mesh=, rules=)`` through ``TrainerLoop``'s ``model_axis``)
on chip_smoke.py's mesh of ``SHARDED_W`` ranks in this process
(``chip_smoke.process_group``), for any of the three cells: parameters,
gradients and moments DTensors, each block in one ``local_map`` on local
shards (``core.distributed.block_map``), the embedding and the loss in one
each; one untraced step after the warm-up is counted
(``core.distributed.DispatchCounter``: the ops dispatched on DTensors and
DTensor's redistributions a step); the tables go to NAME_sharded. Prints
one JSON line with the card's name and power
limit: each traced step's wall ms (synchronised; the profiler slows the
host, so step times come from chip_smoke.py's unprofiled train runs), the
device busy ms a step and the device's idle share of the traced span, the
device ms a step by kernel class (the port's scan, attention and other
hand-written kernels, matmuls, elementwise, reductions, copies, the rest),
device kernels and host-side aten ops a step, and the host's 12 costliest
events by self time (ms a step and calls a step: where the host spends the
device's idle time, e.g. synchronising copies or the allocator's cudaMalloc
/ cudaFree). The profiler's tables (by
device time and by host time) go to DIR (default
chiprun_out/profile_train/NAME).
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from profile_torch_serve import busy_union_us  # noqa: E402

CLASSES = (  # first match wins, on the kernel's name
    ("ssd_scan", ("ssd_kernel", "cb_kernel")),
    ("ssd_scan_bwd", ("pass_kernel", "lam_kernel", "::s_kernel<", "fold_kernel",
                      "fold_da_kernel")),
    ("rglru_scan", ("rglru_kernel",)),
    ("rglru_scan_bwd", ("rglru_bwd_kernel",)),
    ("flash_attention", ("flash_mma_kernel", "flash_kernel", "flash_attention_kernel")),
    ("flash_attention_bwd", ("dq_mma_kernel", "dkdv_mma_kernel", "dq_kernel", "dkdv_kernel",
                             "delta_kernel", "fold_splits_kernel")),
    ("matmul", ("gemm", "gemv", "cutlass", "xmma", "nvjet", "sm90_", "splitk")),
    ("reduce", ("reduce",)),
    ("copy", ("memcpy", "memset", "copy_kernel", "catarray", "indexcopy", "index_put",
              "indexing_backward", "scatter", "gather", "index_elementwise")),
    ("elementwise", ("elementwise", "vectorized")),
)


def kernel_class(name: str) -> str:
    low = name.lower()
    for cls, keys in CLASSES:
        if any(k in low for k in keys):
            return cls
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--arch", default="mamba2-780m")
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default=None)
    ap.add_argument("--sharded", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_train_step: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = chip_smoke.nvidia_smi_line()
    cell = chip_smoke.TRAIN_CELLS[args.arch]
    warmup = 2
    group = chip_smoke.process_group("cuda") if args.sharded else contextlib.nullcontext()
    with group:
        return _profile(args, chip_smoke, cell, warmup, smi)


def _profile(args, chip_smoke, cell, warmup, smi) -> int:
    from repro_torch.runtime import RunConfig, TrainerLoop
    from torch.profiler import ProfilerActivity, profile

    with tempfile.TemporaryDirectory() as ckpt_dir:
        loop = TrainerLoop(RunConfig(arch=args.arch, smoke=False, steps=warmup + args.steps,
                                     batch=cell["batch"], seq=cell["seq"], peak_lr=3e-4, warmup=2,
                                     ckpt_dir=ckpt_dir, remat=True, device="cuda",
                                     model_axis=chip_smoke.SHARDED_W if args.sharded else 1))
    params, state = loop._init_state()
    batches = [chip_smoke._train_batch(loop.cfg, cell["batch"], cell["seq"], "cuda", seed=i)
               for i in range(warmup + args.steps)]
    for b in batches[:warmup]:
        params, state, _ = loop.step_fn(params, state, b)
    dispatch = None
    if args.sharded:
        from repro_torch.core.distributed import DispatchCounter

        with DispatchCounter() as c:
            params, state, _ = loop.step_fn(params, state, batches[0])
        dispatch = {"op_dispatches": c.dtensor_ops, "redistributions": c.redistributions,
                    "ops": c.ops}
    torch.cuda.synchronize()
    step_ms = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for b in batches[warmup:]:
            t0 = time.perf_counter()
            params, state, _ = loop.step_fn(params, state, b)
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    device_events = [e for e in events if getattr(e, "device_type", None) == cuda
                     and not e.name.startswith("ProfilerStep")]
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
    n = args.steps
    averages = prof.key_averages()
    host_top = sorted((e for e in averages if e.self_cpu_time_total > 0),
                      key=lambda e: e.self_cpu_time_total, reverse=True)[:12]
    name = args.arch + ("_sharded" if args.sharded else "")
    out = Path(args.out or ROOT / "chiprun_out" / "profile_train" / name)
    out.mkdir(parents=True, exist_ok=True)
    for sort in ("self_device_time_total", "self_cpu_time_total"):
        try:
            table = averages.table(sort_by=sort, row_limit=40)
        except (AttributeError, KeyError, ValueError):
            table = averages.table(sort_by=sort.replace("device", "cuda"), row_limit=40)
        (out / f"by_{sort}.txt").write_text(table)
    rec = {
        "phase": "train_profile", "nvidia_smi": smi, "arch": args.arch,
        "sharded": ({"ranks": chip_smoke.SHARDED_W, "mesh": list(loop.mesh.shape)}
                    if args.sharded else None),
        "batch": cell["batch"], "seq": cell["seq"], "traced_steps": n,
        "dtensor_per_untraced_step": dispatch,
        "step_ms_traced": step_ms, "span_ms": span_us / 1e3,
        "device_busy_ms_per_step": busy_us / 1e3 / n,
        "device_idle_share": 1.0 - busy_us / span_us if span_us else None,
        "device_ms_per_step_by_class": {k: v / 1e3 / n for k, v in sorted(by_class.items())},
        "device_kernels_per_step": len(device_events) / n,
        "aten_ops_per_step": len(host_ops) / n,
        "host_self_ms_per_step": {e.key: [e.self_cpu_time_total / 1e3 / n, e.count / n]
                                  for e in host_top},
        "tables": str(out),
    }
    print(json.dumps(rec), flush=True)
    if busy_us <= 0:
        print("profile_train_step: the profiler recorded no device time", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
