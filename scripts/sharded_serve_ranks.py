#!/usr/bin/env python3
"""Serving on a mesh across ranks of one host, against the one-device serve.

    python3 scripts/sharded_serve_ranks.py [--world 4] [--device cuda|cpu]
        [--archs NAME ...] [--timeout S] [--no-timed]

Starts ``--world`` processes (one a card on ``cuda``: rank r on ``cuda:r``,
NCCL; on ``cpu``: gloo, one thread each), joined on ``tcp://localhost`` at a
free port. Every rank builds each arch of ``chip_smoke.SHARDED_EXACT`` at its
cut (``--device cpu``: the smoke configs) in f32 with TF32 off, from the same
seed (the attention projections rescaled to their fan-in, the vision gate
``chip_smoke.SHARDED_VISION_GATE``, the MoE's capacity factor ``MOE_CF``: no
entry dropped) and the same B 4 prompts of PROMPT tokens. Rank 0 serves them
on one device: make_prefill(max_len = PROMPT + STEPS) and STEPS greedy
make_serve_step steps. Then, on each of the ("data", "model") meshes (2, 2),
(4, 1) and (1, 4) (for ``--world 4``), every rank serves them through the
mesh under ``serve_rules`` (FSDP on "embed" where ``needs_fsdp_for_serving``:
kimi-k2): the dense caches split along S over "model" (the kv_seq-sharded
decode: flash_decode over the rank's slice with its lse, merged across the
ranks), the scan states by heads or columns. Rank 0 prints one JSON line a
(arch, mesh): whether the greedy tokens equal the one-device ones and the
logits' largest difference over their max-abs (gates: equal, 1e-4), the
collectives of one decode step (``core.distributed.CollectiveCounter``:
calls and input bytes), the family's kernels' launches in the mesh run on
rank 0, and the card's name and power limit.

Then (``cuda``, unless ``--no-timed``) llama3.2-1b at full width in bf16 on
the (1, world) mesh with the S-split cache (TIMED: B 8, a 4096-token prompt
in a 32768-slot cache, 32 new tokens): rank 0's one-device run first (the
other ranks wait), then the mesh run on every rank: step ms (p50 of the
decode steps, every rank's), the tokens against the one-device run's (the
first differing step of each row: bf16 sums over the ranks round otherwise;
the prefill logits' largest difference beside the one-device top-1 / top-2
gaps), one step's collectives, each rank's peak memory, and rank 0's
torch.profiler trace of 4 more steps (the device's idle share, NCCL kernels'
ms and the rest's, the host's costliest ops by self time). Last, llama3.2-1b
at full width and depth through the same mesh against rank 0's one-device
serve, f32 and bf16 (FULL_DEPTH, conditioned weights): tokens and logits,
printed. The last line is {"ok": ...};
the exit code is 0 only when every rank exited 0 and every gate held.
Processes still running at ``--timeout`` are killed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
MESHES = {4: ((2, 2), (4, 1), (1, 4)), 2: ((2, 1), (1, 2))}
MOE_CF = 64.0
PROMPT, STEPS, BATCH = 56, 8, 4  # PROMPT + STEPS slots: S divides every model axis
TIMED = dict(batch=8, prompt=4096, slots=32768, new=32)
FULL_DEPTH = dict(batch=8, prompt=1024, slots=2048, new=8)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _exact(args, chip_smoke, device, cuda, smi) -> bool:
    """Every arch on every mesh against rank 0's one-device serve."""
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import kernels
    from repro_torch.core.distributed import CollectiveCounter
    from repro_torch.launch import needs_fsdp_for_serving, serve_rules
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import distribute_params

    ok = True
    for arch in args.archs:
        cut = chip_smoke.SHARDED_EXACT[arch][0]
        cfg = dataclasses.replace(get_config(arch, smoke=not cuda), dtype="float32")
        if cuda:
            cfg = dataclasses.replace(cfg, **cut)
        if cfg.family == "moe":
            cfg = dataclasses.replace(cfg, capacity_factor=MOE_CF)
        model = build_model(cfg, device=device)
        params = chip_smoke.condition_attention(
            cfg, model.init_params(torch.Generator(device=device).manual_seed(0)))
        if cfg.family == "vlm":
            for group in params["blocks"][0]:
                group["gate"].fill_(chip_smoke.SHARDED_VISION_GATE)
        t = PROMPT if cuda else 12
        prompts, bi = chip_smoke.serve_inputs(cfg, BATCH, t, device)
        want = None
        if args.rank == 0:
            want = chip_smoke.generate(model, params, prompts, STEPS, batch_inputs=bi)
        rules = serve_rules(cfg, fsdp_params=needs_fsdp_for_serving(get_config(arch)))
        need = chip_smoke.SERVE_KERNELS[cfg.family]
        for shape in MESHES[args.world]:
            mesh = DeviceMesh(device.split(":")[0], torch.arange(args.world).reshape(shape),
                              mesh_dim_names=("data", "model"))
            pd = distribute_params(model, params, mesh, rules)
            kernels.reset_launch_counts()
            st = []
            toks, (_, last), _, _ = chip_smoke.generate(model, pd, prompts, STEPS, batch_inputs=bi,
                                                        mesh=mesh, rules=rules, state=st)
            step, caches, nxt, pos = st
            counts = kernels.launch_counts()
            counter = CollectiveCounter()
            with counter:
                step(pd, caches, nxt, pos)
            del pd, caches
            if args.rank != 0:
                continue
            want_toks, want_last = want[0], want[1][1]
            rel = float((last - want_last).abs().max()) / float(want_last.abs().max())
            launched = {k: counts[k] for k in need}
            held = toks == want_toks and rel <= 1e-4 and (not cuda or all(launched.values()))
            ok &= held
            print(json.dumps({
                "phase": "sharded_serve_ranks", "nvidia_smi": smi, "device": args.device,
                "world": args.world, "mesh": list(shape), "arch": arch, "family": cfg.family,
                "layers": cfg.n_layers, "d_model": cfg.d_model, "batch": BATCH, "prompt": t,
                "steps": STEPS, "slots": t + STEPS, "dtype": "float32",
                "fsdp_params": needs_fsdp_for_serving(get_config(arch)),
                "tokens_equal": toks == want_toks, "last_logits_rel": rel,
                "tolerance": "tokens equal, logits 1e-4 of their max-abs",
                "collectives_decode_step": {"calls": counter.calls, "input_bytes": counter.bytes},
                "kernel_launches_rank0": launched, "held": held}), flush=True)
        del model, params
        if cuda:
            torch.cuda.empty_cache()
    return ok


def _timed(args, chip_smoke, device, smi) -> bool:
    """llama3.2-1b bf16 at full width on (1, world) with the S-split cache."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.core.distributed import CollectiveCounter
    from repro_torch.launch import serve_rules
    from repro_torch.serving import distribute_params

    cfg, model, params = chip_smoke.generate_model("llama3.2-1b", "bfloat16", None, False, device)
    b, s, slots, n_new = TIMED["batch"], TIMED["prompt"], TIMED["slots"], TIMED["new"]
    prompts = torch.tensor(np.random.default_rng(6).integers(0, cfg.vocab, size=(b, s)),
                           device=device)
    one = None
    if args.rank == 0:
        chip_smoke.generate(model, params, prompts, 4, slots=slots)  # warm-up
        one = chip_smoke.generate(model, params, prompts, n_new, slots=slots)
        one = (one[0], statistics.median(one[3]) * 1e3, one[1][0])
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = DeviceMesh("cuda", torch.arange(args.world).reshape(1, args.world),
                      mesh_dim_names=("data", "model"))
    rules = serve_rules(cfg)
    pd = distribute_params(model, params, mesh, rules)
    del params
    chip_smoke.generate(model, pd, prompts, 4, mesh=mesh, rules=rules, slots=slots)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    st = []
    toks, (first, _), _, steps = chip_smoke.generate(model, pd, prompts, n_new, mesh=mesh,
                                                     rules=rules, slots=slots, state=st)
    step, caches, nxt, pos = st
    counter = CollectiveCounter()
    with counter:
        step(pd, caches, nxt, pos)
    peak = torch.cuda.max_memory_allocated()
    trace = _profile_steps(lambda: [step(pd, caches, nxt, pos + 1 + i) for i in range(4)],
                           args.rank == 0)
    p50 = statistics.median(steps) * 1e3
    gathered = [None] * args.world
    dist.all_gather_object(gathered, {"step_ms_p50": p50, "peak": peak})
    if args.rank != 0:
        return True
    same = toks == one[0]
    first_diff = [next((j for j, (a, b) in enumerate(zip(g, w)) if a != b), None)
                  for g, w in zip(toks, one[0])]
    want = one[2][:, :cfg.vocab]
    top2 = want.topk(2, dim=-1).values
    prefill = {"logits_max_abs_diff": float((first[:, :cfg.vocab] - want).abs().max()),
               "logits_max_abs": float(want.abs().max()),
               "one_device_top1_top2_gap_each_row": (top2[:, 0] - top2[:, 1]).tolist()}
    print(json.dumps({
        "phase": "sharded_serve_ranks_timed", "nvidia_smi": smi, "world": args.world,
        "mesh": [1, args.world], "arch": cfg.name, "dtype": cfg.dtype, "layers": cfg.n_layers,
        "d_model": cfg.d_model, "heads": [cfg.n_heads, cfg.n_kv_heads], "head_dim": cfg.head_dim,
        "batch": b, "prompt": s, "cache_slots": slots, "slots_per_rank": slots // args.world,
        "new_tokens": n_new, "tokens_equal_one_device": same,
        "first_differing_step_each_row": first_diff, "prefill_logits": prefill,
        "rank0_trace_4_steps": trace,
        "step_ms_p50_one_device": one[1], "step_ms_p50_mesh_rank0": p50,
        "step_ms_p50_each_rank": [g["step_ms_p50"] for g in gathered],
        "step_ms_rank0": [t * 1e3 for t in steps],
        "peak_memory_bytes_each_rank": [g["peak"] for g in gathered],
        "collectives_decode_step": {"calls": counter.calls, "input_bytes": counter.bytes},
        "merge_bytes_a_layer": b * cfg.n_heads * (cfg.head_dim + 2) * 4}), flush=True)
    return True


def _full_depth(args, chip_smoke, device, smi, dtype) -> None:
    """llama3.2-1b at full width and depth in ``dtype`` (TF32 off, the
    attention projections rescaled to their fan-in) on (1, world) with the
    S-split cache (FULL_DEPTH) against rank 0's one-device serve: tokens and
    logits, printed (not gated: at full depth two correct computations may
    part on a near tie, and in bf16 the row-parallel sums over the ranks
    round otherwise than one device's matmul)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch.launch import serve_rules
    from repro_torch.serving import distribute_params

    cfg, model, params = chip_smoke.generate_model("llama3.2-1b", dtype, None, False, device,
                                                   conditioned=True)
    b, s, slots, n_new = (FULL_DEPTH["batch"], FULL_DEPTH["prompt"], FULL_DEPTH["slots"],
                          FULL_DEPTH["new"])
    prompts = torch.tensor(np.random.default_rng(7).integers(0, cfg.vocab, size=(b, s)),
                           device=device)
    want = chip_smoke.generate(model, params, prompts, n_new, slots=slots) if args.rank == 0 \
        else None
    dist.barrier()
    mesh = DeviceMesh("cuda", torch.arange(args.world).reshape(1, args.world),
                      mesh_dim_names=("data", "model"))
    pd = distribute_params(model, params, mesh, serve_rules(cfg))
    del params
    toks, (first, last), _, _ = chip_smoke.generate(model, pd, prompts, n_new, mesh=mesh,
                                                    rules=serve_rules(cfg), slots=slots)
    del pd
    torch.cuda.empty_cache()
    if args.rank != 0:
        return
    rel = [float((a - w).abs().max()) / float(w.abs().max())
           for a, w in ((first, want[1][0]), (last, want[1][1]))]
    print(json.dumps({
        "phase": "sharded_serve_ranks_full_depth", "nvidia_smi": smi, "world": args.world,
        "mesh": [1, args.world], "arch": cfg.name, "dtype": dtype, "init": "conditioned",
        "layers": cfg.n_layers, "d_model": cfg.d_model, "batch": b, "prompt": s,
        "cache_slots": slots, "new_tokens": n_new, "tokens_equal_one_device": toks == want[0],
        "first_differing_step_each_row": [
            next((j for j, (x, y) in enumerate(zip(g, w)) if x != y), None)
            for g, w in zip(toks, want[0])],
        "prefill_logits_rel": rel[0], "last_logits_rel": rel[1]}), flush=True)


def _profile_steps(fn, traced: bool):
    """``fn()`` (every rank runs it: its collectives need all of them), under
    torch.profiler where ``traced``: the traced span, the device's busy
    union and idle share, and the device ms of the NCCL kernels and of the
    rest; None where the profiler records no device time or untraced."""
    if not traced:
        fn()
        torch.cuda.synchronize()
        return None
    from chip_smoke import _busy_union_us
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    dev = [e for e in events if getattr(e, "device_type", None) == cuda
           and not e.name.startswith("ProfilerStep")]
    if not dev:
        return None
    span = max(e.time_range.end for e in events) - min(e.time_range.start for e in events)
    busy = _busy_union_us([(e.time_range.start, e.time_range.end) for e in dev])
    nccl = sum(e.time_range.elapsed_us() for e in dev if "nccl" in e.name.lower())
    other = sum(e.time_range.elapsed_us() for e in dev if "nccl" not in e.name.lower())
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count) for e in prof.key_averages()),
                  key=lambda r: -r[1])[:12]
    return {"span_ms": span / 1e3, "device_busy_ms": busy / 1e3,
            "device_idle_share": 1.0 - busy / span if span else None,
            "nccl_kernel_ms": nccl / 1e3, "other_kernel_ms": other / 1e3,
            "nccl_kernels": sum("nccl" in e.name.lower() for e in dev),
            "device_kernels": len(dev), "host_self_ms_top": host}


def _rank(args) -> int:
    import torch.distributed as dist

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(args.rank)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        device = f"cuda:{args.rank}"
    else:
        torch.set_num_threads(1)
        device = "cpu"
    dist.init_process_group("nccl" if cuda else "gloo", init_method=f"tcp://localhost:{args.port}",
                            world_size=args.world, rank=args.rank)
    smi = chip_smoke.nvidia_smi_line() if cuda and args.rank == 0 else None
    try:
        ok = _exact(args, chip_smoke, device, cuda, smi)
        if cuda and not args.no_timed:
            ok &= _timed(args, chip_smoke, device, smi)
            for dtype in ("float32", "bfloat16"):
                _full_depth(args, chip_smoke, device, smi, dtype)
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--world", type=int, default=4, choices=sorted(MESHES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    ap.add_argument("--no-timed", action="store_true")
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--port", type=int, default=None)
    args = ap.parse_args()
    if args.archs is None:
        sys.path[:0] = [str(ROOT), str(ROOT / "src")]
        import chip_smoke

        args.archs = list(chip_smoke.SHARDED_EXACT)
    if args.rank is not None:
        return _rank(args)
    if args.device == "cuda" and torch.cuda.device_count() < args.world:
        print(f"sharded_serve_ranks: {args.world} ranks need {args.world} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.device == "cuda":  # once here, not in every rank at once
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build

        _build.build_all()
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    extra = ["--no-timed"] if args.no_timed else []
    procs = [subprocess.Popen([sys.executable, __file__, "--world", str(args.world), "--device",
                               args.device, "--rank", str(r), "--port", str(port), *extra,
                               "--archs", *args.archs],
                              env=env, stdout=None if r == 0 else subprocess.DEVNULL)
             for r in range(args.world)]
    deadline = time.monotonic() + args.timeout
    codes = []
    for p in procs:
        try:
            codes.append(p.wait(timeout=max(deadline - time.monotonic(), 1)))
        except subprocess.TimeoutExpired:
            codes.append("timeout")
    for p in procs:
        if p.poll() is None:
            p.kill()
            p.wait()
    ok = all(c == 0 for c in codes)
    print(json.dumps({"ok": ok, "exit_codes": codes}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
