#!/usr/bin/env python3
"""Can several ranks share one card through gloo? The probe that fixes the
rank count of ``chip_smoke.py``'s sharded phases.

    python3 scripts/probe_card_ranks.py [--world 2] [--device cuda|cpu]

Spawns ``--world`` processes (2 by default) on ``cuda:0`` (or on the CPU),
joined by ``torch.distributed`` with the backend ``"cpu:gloo,cuda:gloo"``
(``"gloo"`` on the CPU) through a ``file://`` store in a temporary
directory. Each rank runs ``checks``: ``all_reduce``,
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and
``all_to_all_single`` on tensors of the device, each against the values it
must give, then the backward of a DTensor matmul followed by
``log_softmax`` on a (1, world) ("data", "model") mesh against the
unsharded gradient. Each rank logs the name of a step before it takes it
and each check's result after it (and ``faulthandler`` prints a crash's
stack), so a rank that dies names the step it died in and the checks it
passed before. The parent prints the torch and CUDA versions, then one
JSON line a check (its name, whether every rank passed it, the first
failure's text), then ``{"probe": "all_passed", ...}``. Exits 0 when every
check passed on every rank, 1 otherwise. NCCL refuses two ranks on one
GPU, so on one card this is the only way to run more than one rank.
"""
from __future__ import annotations

import argparse
import faulthandler
import json
import os
import subprocess
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

CHECKS = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
          "all_to_all_single", "dtensor_matmul_backward")


def backend_for(device: str) -> str:
    return "cpu:gloo,cuda:gloo" if device == "cuda" else "gloo"


def _collectives(rank: int, world: int, device: str):
    """The four collectives on ``device`` tensors: name -> a thunk that
    raises AssertionError on a wrong value."""
    dev = torch.device(device)

    def all_reduce():
        x = torch.arange(4, dtype=torch.float32, device=dev) + rank
        dist.all_reduce(x)
        want = torch.arange(4, dtype=torch.float32) * world + sum(range(world))
        assert torch.equal(x.cpu(), want), x

    def all_gather():
        x = torch.full((3,), float(rank), device=dev)
        out = torch.empty(3 * world, device=dev)
        dist.all_gather_into_tensor(out, x)
        want = torch.arange(world, dtype=torch.float32).repeat_interleave(3)
        assert torch.equal(out.cpu(), want), out

    def reduce_scatter():
        x = torch.arange(2 * world, dtype=torch.float32, device=dev) * (rank + 1)
        out = torch.empty(2, device=dev)
        dist.reduce_scatter_tensor(out, x)
        scale = sum(r + 1 for r in range(world))
        want = torch.arange(2 * rank, 2 * rank + 2, dtype=torch.float32) * scale
        assert torch.equal(out.cpu(), want), out

    def all_to_all():
        x = torch.arange(world, dtype=torch.float32, device=dev) + 10 * rank
        out = torch.empty(world, device=dev)
        dist.all_to_all_single(out, x)
        want = torch.arange(world, dtype=torch.float32) * 10 + rank
        assert torch.equal(out.cpu(), want), out

    return {"all_reduce": all_reduce, "all_gather_into_tensor": all_gather,
            "reduce_scatter_tensor": reduce_scatter, "all_to_all_single": all_to_all}


def _dtensor_backward(world: int, device: str):
    """d log_softmax(x @ w)[:, 0].sum() / dw with w sharded on its columns
    over "model", against the same gradient taken unsharded."""
    from torch.distributed.device_mesh import DeviceMesh
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    mesh = DeviceMesh(device, torch.arange(world).reshape(1, world),
                      mesh_dim_names=("data", "model"))
    g = torch.Generator().manual_seed(0)
    x = torch.randn(8, 16, generator=g).to(device)
    w = torch.randn(16, 4 * world, generator=g).to(device)
    wd = distribute_tensor(w, mesh, [Replicate(), Shard(1)]).detach().requires_grad_()
    xd = distribute_tensor(x, mesh, [Replicate(), Replicate()])
    torch.log_softmax(xd @ wd, dim=-1)[:, 0].sum().backward()
    got = wd.grad.full_tensor().cpu()
    wp = w.clone().requires_grad_()
    torch.log_softmax(x @ wp, dim=-1)[:, 0].sum().backward()
    err = float((got - wp.grad.cpu()).abs().max())
    assert err < 1e-5, err


def checks(rank: int, world: int, device: str, log=None):
    """Every check on this rank (the process group must be up) -> {name:
    None when it passed, else the failure's text}. ``log(line)`` is called
    with each check's name before it runs and with ``name=result`` after."""
    out = {}
    thunks = dict(_collectives(rank, world, device))
    thunks["dtensor_matmul_backward"] = lambda: _dtensor_backward(world, device)
    for name in CHECKS:
        if log is not None:
            log(name)
        try:
            thunks[name]()
            if device == "cuda":
                torch.cuda.synchronize()
            out[name] = None
        except Exception as e:  # reported, never hidden: the parent fails on it
            out[name] = f"{type(e).__name__}: {e}".splitlines()[0][:300]
        if log is not None:
            log(f"{name}={'passed' if out[name] is None else 'failed'}")
    return out


def _rank_main(args) -> int:
    faulthandler.enable()
    here = os.path.dirname(args.store)
    steps = open(os.path.join(here, f"rank{args.rank}.steps"), "w")

    def log(step):
        steps.write(step + "\n")
        steps.flush()

    log("set_device")
    if args.device == "cuda":
        torch.cuda.set_device(0)
    log("init_process_group")
    dist.init_process_group(backend_for(args.device), init_method=f"file://{args.store}",
                            world_size=args.world, rank=args.rank)
    try:
        res = checks(args.rank, args.world, args.device, log)
    except Exception:
        res = {"setup": traceback.format_exc()[-300:]}
    with open(os.path.join(here, f"rank{args.rank}.json"), "w") as f:
        json.dump(res, f)
    log("destroy_process_group")
    dist.destroy_process_group()
    log("done")
    return 0


def _steps_of(here: str, rank: int):
    """(the checks a rank that died logged as passed or failed, the step it
    died in)."""
    path = os.path.join(here, f"rank{rank}.steps")
    lines = open(path).read().split() if os.path.exists(path) else []
    done = dict(line.split("=") for line in lines if "=" in line)
    return ({k: None if v == "passed" else "failed (see the rank's output)"
             for k, v in done.items()}, lines[-1] if lines else "start")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--world", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--rank", type=int, default=None)
    ap.add_argument("--store", default=None)
    args = ap.parse_args()
    if args.rank is not None:
        return _rank_main(args)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("probe_card_ranks: no CUDA device", file=sys.stderr)
        return 2
    print(json.dumps({"torch": torch.__version__, "cuda": torch.version.cuda,
                      "python": sys.version.split()[0], "world": args.world,
                      "device": args.device, "backend": backend_for(args.device)}), flush=True)
    with tempfile.TemporaryDirectory() as d:
        store = os.path.join(d, "store")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   "--world", str(args.world), "--device", args.device,
                                   "--store", store]) for r in range(args.world)]
        try:
            codes = [p.wait(timeout=300) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results = []
        for r in range(args.world):
            path = os.path.join(d, f"rank{r}.json")
            if os.path.exists(path):
                results.append(json.load(open(path)))
                continue
            done, last = _steps_of(d, r)
            results.append(dict(done, setup=f"rank {r} died (exit {codes[r]}) in its step "
                                            f"{last!r}"))
    ok = True
    for name in ("setup",) + CHECKS:
        fails = [res.get(name, "not run") if name != "setup" else res.get("setup")
                 for res in results]
        if name == "setup" and not any(fails):
            continue
        passed = not any(fails)
        ok &= passed
        print(json.dumps({"check": name, "passed": passed,
                          "first_failure": next((f for f in fails if f), None)}), flush=True)
    print(json.dumps({"probe": "all_passed" if ok else "failed", "world": args.world,
                      "exit_codes": codes}), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
