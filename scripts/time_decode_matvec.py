#!/usr/bin/env python3
"""Time the dense-cache decode (flash_decode) and the matvec kernels of one
checkout on one GPU, with recurrentgemma-2b's and qwen2-0.5b's bf16
generate runs on them, so that two trees can be compared in one call.

    python3 scripts/time_decode_matvec.py [--tree DIR] [--label NAME] [--profile]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` and its ``chip_smoke.py`` are imported, and its kernels are
built into DIR/build. Only public entry points are called
(``flash_decode``, ``matvec_right``, ``matvec_left``, ``make_prefill`` and
``make_serve_step`` through chip_smoke.generate_timed), so any two trees of
the port time the same calls. Prints one JSON line per measurement, each
with NAME and the card's name and power limit:

  flash_decode  bf16 at recurrentgemma-2b's ring, q (2, 10, 1, 256) over
                (2, 1, 2048, 256) at pos 2047, and at qwen2-0.5b's generate
                shape, q (8, 14, 1, 64) over (8, 2, 288, 64) at pos 271:
                CUDA-event ms a call (median of 30, host wrapper included),
                device ms a call (50 calls queued behind a sleep kernel),
                the same two for scaled_dot_product_attention on the same
                inputs, and the kernel's largest error against its plain
                version;
  matvec        f32 16384^2, right and left: the same times beside
                torch.mv's, and the error against the plain version;
  generate      chip_smoke's bf16 timed runs of recurrentgemma-2b (B 2 x
                2600, 26 layers) and qwen2-0.5b (B 8 x 256, 24 layers):
                prefill ms, step ms p50, launches.

With --profile, two torch.profiler lines follow: the device time a call of
each kernel the ring's flash_decode launches (20 calls), and a window of 8
bf16 decode steps of recurrentgemma-2b (each step synchronized, as the timed
run's): the window's span, the device's busy time (the union of its kernels)
and idle share, the device time of the decode attention's kernels and of
the rest, the twelve kernels that took most device time a step, and kernels
and aten ops a step.

Compare two trees in turns (A, B, B, A) within one call: serve and generate
times move between calls. Needs one GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import sys
from pathlib import Path

import torch

DECODE_KERNELS = ("split_decode_kernel", "combine_splits_kernel", "flash_kernel")


def _short(name: str) -> str:
    """A kernel's name without its namespace, template arguments and
    parameters."""
    for tok in DECODE_KERNELS:
        if tok in name:
            return tok
    name = name.replace("(anonymous namespace)::", "").replace("void ", "")
    return name.split("<")[0].split("(")[0][:60]


def _device_events(prof):
    cuda = torch.autograd.DeviceType.CUDA
    return [e for e in prof.events() if getattr(e, "device_type", None) == cuda
            and not e.name.startswith("ProfilerStep")]


def profile_decode_call(call, n=20):
    """Device microseconds a call of each kernel ``call`` launches."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    by_kernel = {}
    for e in _device_events(prof):
        k = _short(e.name)
        by_kernel[k] = by_kernel.get(k, 0.0) + e.time_range.elapsed_us() / n
    return by_kernel


def profile_generate_steps(smoke, arch="recurrentgemma-2b", steps=8, warm=4):
    """A window of ``steps`` bf16 decode steps of ``arch`` (the generate
    cell's batch and first prompt), after ``warm`` steps, each step
    synchronized."""
    import statistics
    import time

    import numpy as np
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.serving import make_prefill, make_serve_step

    cell = smoke.GEN_CELLS[arch]
    cfg, model, params = smoke.generate_model(arch, "bfloat16")
    s = cell["prompts"][0]
    prompts = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab,
                                                             size=(cell["batch"], s)),
                           device=model.device)
    logits, caches = make_prefill(model, max_len=s + warm + steps)(params, prompts)
    step = make_serve_step(model)
    nxt = torch.argmax(logits[:, -1, :cfg.vocab], dim=-1).to(torch.int32)
    for i in range(warm):
        logits, caches = step(params, caches, nxt, s + i)
        nxt = torch.argmax(logits[:, :cfg.vocab], dim=-1).to(torch.int32)
    torch.cuda.synchronize()
    host = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for i in range(warm, warm + steps):
            t0 = time.perf_counter()
            logits, caches = step(params, caches, nxt, s + i)
            nxt = torch.argmax(logits[:, :cfg.vocab], dim=-1).to(torch.int32)
            torch.cuda.synchronize()
            host.append((time.perf_counter() - t0) * 1e3)
    dev = _device_events(prof)
    events = prof.events()
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -float("inf")
    for a, b in spans:
        if b > end:
            busy += b - max(a, end)
            end = b
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    attn = sum(e.time_range.elapsed_us() for e in dev if _short(e.name) in DECODE_KERNELS)
    by_kernel = {}
    for e in dev:
        k = _short(e.name)
        by_kernel[k] = by_kernel.get(k, 0.0) + e.time_range.elapsed_us() / 1e3 / steps
    top = dict(sorted(by_kernel.items(), key=lambda kv: -kv[1])[:12])
    cuda = torch.autograd.DeviceType.CUDA
    aten = [e for e in events if getattr(e, "device_type", None) != cuda
            and e.name.startswith("aten::")
            and not (e.cpu_parent is not None and e.cpu_parent.name.startswith("aten::"))]
    return {"profile": "generate_decode_steps", "model": cfg.name, "steps": steps,
            "span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / span,
            "decode_attention_device_ms_per_step": attn / 1e3 / steps,
            "other_device_ms_per_step": (sum(e.time_range.elapsed_us() for e in dev) - attn)
            / 1e3 / steps,
            "device_ms_per_step_top_kernels": top,
            "kernels_per_step": len(dev) / steps, "aten_ops_per_step": len(aten) / steps,
            "profiled_step_ms_p50": statistics.median(host)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_decode_matvec: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    smoke = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matvec as mv
    import torch.nn.functional as F

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    card = smoke.nvidia_smi_line()
    base = {"label": args.label, "tree": str(tree), "card": card}
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=g, device="cuda").to(dt)

    for shape, (b, hq, hkv, s, d, pos) in (("ring", (2, 10, 1, 2048, 256, 2047)),
                                           ("qwen2", (8, 14, 2, 288, 64, 271))):
        q, kc, vc = rnd(b, hq, 1, d), rnd(b, hkv, s, d), rnd(b, hkv, s, d)
        pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
        live = (torch.arange(s, device="cuda") <= pos)[None, None, None]
        kernel = lambda: fa.flash_decode(q, kc, vc, pos_t)
        library = lambda: F.scaled_dot_product_attention(q, kc, vc, attn_mask=live,
                                                         enable_gqa=True)
        err = float((kernel().float() - fa.decode_attention_torch(q, kc, vc, pos).float())
                    .abs().max())
        print(json.dumps({**base, "kernel": "flash_decode", "shape": shape,
                          "q": [b, hq, 1, d], "cache": [b, hkv, s, d], "pos": pos,
                          "ms": smoke.time_ms(kernel), "device_ms": smoke.device_ms_per_call(
                              kernel, n=50),
                          "library_ms": smoke.time_ms(library),
                          "library_device_ms": smoke.device_ms_per_call(library, n=50),
                          "max_abs_err": err}), flush=True)
        if args.profile and shape == "ring":
            print(json.dumps({**base, "profile": "flash_decode ring, device us a call by kernel",
                              "us": profile_decode_call(kernel)}), flush=True)
    m = 16384
    a, x = rnd(m, m, dt=torch.float32), rnd(m, dt=torch.float32)
    at = a.t().contiguous()
    for name, kernel, library in (("matvec_right", lambda: mv.matvec_right(a, x),
                                   lambda: torch.mv(a, x)),
                                  ("matvec_left", lambda: mv.matvec_left(at, x),
                                   lambda: torch.mv(at.t(), x))):
        err = float((kernel() - mv.matvec_torch(a, x)).abs().max())
        print(json.dumps({**base, "kernel": name, "I": m, "J": m, "dtype": "float32",
                          "ms": smoke.time_ms(kernel), "device_ms": smoke.device_ms_per_call(
                              kernel, n=20),
                          "library_ms": smoke.time_ms(library),
                          "library_device_ms": smoke.device_ms_per_call(library, n=20),
                          "max_abs_err": err}), flush=True)
    del a, at, x
    torch.cuda.empty_cache()
    for arch in ("recurrentgemma-2b", "qwen2-0.5b"):
        smoke.emit = lambda rec: print(json.dumps({**base, **rec}), flush=True)
        smoke.generate_timed(arch)
        torch.cuda.empty_cache()
    if args.profile:
        print(json.dumps({**base, **profile_generate_steps(smoke)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
