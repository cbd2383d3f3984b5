#!/usr/bin/env python3
"""Time chip_smoke's serve workload of one checkout in several decode modes
on one GPU, so that two trees (and the modes of one) can be compared in one
call.

    python3 scripts/time_serve_modes.py [--tree DIR] [--label NAME]
                                        [--modes plain,multi4,spec] [--runs N]
                                        [--dispatch REPS [--profile]]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` and its ``chip_smoke.py`` are imported, its kernels are built
into DIR/build, and chip_smoke's ``serve_setup`` / ``serve_phase`` run the
workload (qwen2-0.5b at full size, bf16, page 16, max_batch 8, chunked
prefill 128, prefix sharing, 16 requests, 32 new tokens each) on fresh
engines. Modes: ``plain`` (EngineConfig as the workload's), ``multi4``
(multi_step=4), ``spec`` (spec_tokens=4, multi_step=2); a tree whose engine
refuses a mode (a checkout before the fused and speculative decode) takes
``plain`` only. Each mode runs ``--runs`` times, the modes in turn. Prints
chip_smoke's serve record of every run with NAME, the mode and the card's
name and power limit: tokens/s, step ms p50 / p95, TTFT p95, fused steps and
the speculative metrics. Serve times move between calls: compare trees in
turns (A, B, B, A) within one call.

``--dispatch REPS`` times the decode dispatch alone instead, at the serve
batch (qwen2-0.5b, bf16, B 8, page 16, resident lengths 300-349): one call of
the step factory's function then a synchronize, median of REPS after 3
warm-ups, for ``plain`` (make_paged_serve_step), ``multi4``
(make_paged_serve_multistep, K 4) and ``spec`` (make_paged_serve_spec_multistep,
K 4, S 2, empty n-gram rows: every draft is rejected, one token a window),
the modes this tree has: ms a dispatch and a token, greedy. ``--profile``
then traces 4 dispatches of each mode with torch.profiler (CPU and CUDA
activities): wall ms, the host's self time in aten ops, the device's busy
time (kernels and copies), its idle share of the window, aten ops and kernel
launches, each a token. Needs one GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

MODES = {"plain": None, "multi4": dict(multi_step=4), "spec": dict(spec_tokens=4, multi_step=2)}


def profile_dispatch(fn, args, tokens_a_dispatch, n=4):
    """torch.profiler over ``n`` synchronized dispatches of ``fn``: per token,
    wall ms, host self ms in aten ops, device busy ms, aten ops and kernel
    launches, and the device's idle share of the window."""
    import time

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn(*args)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    aten = [e for e in events if e.key.startswith("aten::")]
    device_us = sum(e.self_device_time_total for e in events
                    if e.device_type == torch.autograd.DeviceType.CUDA)
    launches = sum(e.count for e in events if e.key in ("cudaLaunchKernel", "cuLaunchKernel",
                                                        "cudaLaunchKernelExC"))
    tokens = n * tokens_a_dispatch
    return {"wall_ms_a_token": wall * 1e3 / tokens,
            "host_aten_self_ms_a_token": sum(e.self_cpu_time_total for e in aten) / 1e3 / tokens,
            "device_busy_ms_a_token": device_us / 1e3 / tokens,
            "device_idle_share": 1.0 - device_us / 1e6 / wall,
            "aten_ops_a_token": sum(e.count for e in aten) / tokens,
            "kernel_launches_a_token": launches / tokens}


def time_dispatch(modes, reps, emit, profile=False):
    """ms a decode dispatch of each mode at the serve batch (see --dispatch)."""
    import statistics
    import time

    from repro_torch.models import build_model, get_config
    from repro_torch.serving import step as step_mod

    cfg = get_config("qwen2-0.5b")
    model = build_model(cfg)
    params = model.init_params(torch.Generator(device="cuda").manual_seed(1))
    b, ps, max_pages = 8, 16, 40
    num_pages = b * max_pages + 1
    caches = model.init_paged_cache(num_pages, ps)
    tables = torch.arange(1, num_pages, dtype=torch.int32, device="cuda").reshape(b, max_pages)
    lens = torch.tensor([300 + 7 * i for i in range(b)], dtype=torch.int32, device="cuda")
    tokens = torch.randint(0, cfg.vocab, (b,), dtype=torch.int32, device="cuda",
                           generator=torch.Generator(device="cuda").manual_seed(2))
    slot_f32 = torch.stack([torch.zeros(b), torch.ones(b)]).cuda()
    slot_i32 = torch.stack([torch.ones(b, dtype=torch.int32),
                            torch.zeros(b, dtype=torch.int32),
                            torch.zeros(b, dtype=torch.int32)]).cuda()
    calls = {"plain": (step_mod.make_paged_serve_step(model), (), 1)}
    if hasattr(step_mod, "make_paged_serve_multistep"):
        calls["multi4"] = (step_mod.make_paged_serve_multistep(model, 4), (), 4)
    try:
        from repro_torch.serving.speculative import (
            NGramProposer,
            make_paged_serve_spec_multistep,
        )
    except ImportError:
        pass
    else:
        prop = NGramProposer(spec_tokens=4, table_size=512, vocab=cfg.vocab,
                             hist_len=max_pages * ps + 6)
        hist = torch.zeros((b, prop.hist_len), dtype=torch.int32, device="cuda")
        table = torch.zeros((b, prop.table_size + 1), dtype=torch.int32, device="cuda")
        calls["spec"] = (make_paged_serve_spec_multistep(model, 2, prop), (hist, table), 2)
    for mode in modes:
        if mode not in calls:
            continue
        fn, extra, tokens_a_dispatch = calls[mode]
        times = []
        for i in range(reps + 3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(params, caches, tokens, tables, lens, slot_f32, slot_i32, *extra, sampled=False)
            torch.cuda.synchronize()
            if i >= 3:
                times.append(time.perf_counter() - t0)
        ms = statistics.median(times) * 1e3
        rec = {"mode": mode, "dispatch_ms_p50": ms, "ms_a_token": ms / tokens_a_dispatch,
               "dispatch_ms_min": min(times) * 1e3, "reps": reps,
               "tokens_a_dispatch": tokens_a_dispatch}
        if profile:
            args = (params, caches, tokens, tables, lens, slot_f32, slot_i32, *extra)
            rec["profile"] = profile_dispatch(lambda *a: fn(*a, sampled=False), args,
                                              tokens_a_dispatch)
        emit(rec)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--modes", default="plain,multi4,spec")
    ap.add_argument("--runs", type=int, default=2)
    ap.add_argument("--dispatch", type=int, default=0)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_serve_modes: no CUDA device", file=sys.stderr)
        return 2
    modes = args.modes.split(",")
    unknown = set(modes) - set(MODES)
    if unknown:
        raise SystemExit(f"unknown modes {sorted(unknown)}; choose from {sorted(MODES)}")
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    smoke = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    base = {"label": args.label, "tree": str(tree), "card": smoke.nvidia_smi_line()}
    if args.dispatch:
        time_dispatch(modes, args.dispatch, lambda rec: print(json.dumps({**base, **rec}),
                                                                flush=True), args.profile)
        return 0
    workload = smoke.serve_setup()
    for _ in range(args.runs):
        for mode in modes:
            kw = MODES[mode]
            rec = (smoke.serve_phase(workload=workload) if kw is None
                   else smoke.serve_phase(workload=workload, engine_kw=kw))
            print(json.dumps({**base, "mode": mode, **rec}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
