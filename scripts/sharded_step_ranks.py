#!/usr/bin/env python3
"""The sharded train step across ranks of one host, against the one-device step.

    python3 scripts/sharded_step_ranks.py [--world 4] [--device cuda|cpu]
        [--archs NAME ...] [--seq T] [--timeout S]

Starts ``--world`` processes (one a card on ``cuda``: rank r on ``cuda:r``,
NCCL; on ``cpu``: gloo, one thread each), joined on ``tcp://localhost`` at a
free port. Every rank builds each arch of ``chip_smoke.SHARDED_EXACT`` at its
cut (``--device cpu``: the smoke configs) in f32 with TF32 off, from the same
seed (the attention projections rescaled to their fan-in, the vision gate
``chip_smoke.SHARDED_VISION_GATE``, the MoE's capacity factor ``MOE_CF``: no
entry dropped), and a SyntheticLM batch of 4 x T tokens.
Rank 0 computes the one-device ``loss_and_grads`` (the MoE's aux loss weighed
0 where expert parallelism runs over more than one token shard: there it is
the mean of the shards' losses, the reference's ``pmean``); then, on each of the
("data", "model") meshes (2, 2), (4, 1) and (1, 4) (for ``--world 4``),
every rank runs the sharded ``loss_and_grads`` (each block in one block map,
its collectives between the ranks), counting the collectives of the call
(``core.distributed.CollectiveCounter``) and its kernel launches, and the
gradients are gathered whole. Rank 0 prints one JSON line a mesh: the loss's
and the worst gradient leaf's relative difference from the one-device step
(gates: 1e-5 and ``chip_smoke.TRAIN_EXACT_RTOL`` of each leaf's max-abs),
the collectives' calls and input bytes, the family's kernels' launches on
rank 0, and the card's name and power limit; the last line is
{"ok": ...}. The exit code is 0 only when every rank exited 0 and every
gate held. Processes still running at ``--timeout`` are killed.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
MESHES = {4: ((2, 2), (4, 1), (1, 4)), 2: ((2, 1), (1, 2))}
MOE_CF = 64.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(args) -> int:
    import torch.distributed as dist

    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke
    from torch.distributed.device_mesh import DeviceMesh

    from repro_torch import kernels
    from repro_torch.core.distributed import CollectiveCounter, tree_distribute, tree_full
    from repro_torch.launch import train_rules
    from repro_torch.models import build_model, get_config
    from repro_torch.models.layers import Sharder
    from repro_torch.train import TrainProfile, loss_and_grads
    from repro_torch.train.step import place_batch

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
    ok = True
    try:
        for arch in args.archs:
            cut, _, seq = chip_smoke.SHARDED_EXACT[arch]
            cfg = dataclasses.replace(get_config(arch, smoke=not cuda), dtype="float32")
            if cuda:
                cfg = dataclasses.replace(cfg, **cut)
            if cfg.family == "moe":
                # a capacity no expert fills: the random router is skewed, and
                # where entries drop, the per-shard capacity of expert
                # parallelism over several token shards drops other entries
                # than one device's global capacity (ROADMAP Queue 3)
                cfg = dataclasses.replace(cfg, capacity_factor=MOE_CF)
            seq = min(seq, args.seq) if cuda else 16
            model = build_model(cfg, device=device)
            params = chip_smoke.condition_attention(
                cfg, model.init_params(torch.Generator(device=device).manual_seed(0)))
            if cfg.family == "vlm":
                for group in params["blocks"][0]:
                    group["gate"].fill_(chip_smoke.SHARDED_VISION_GATE)
            batch = chip_smoke._train_batch(cfg, 4, seq, device)
            want = {}
            rules = train_rules(cfg)
            need = chip_smoke.TRAIN_KERNELS.get(cfg.family, chip_smoke.TRAIN_ATTN_KERNELS)
            for shape in MESHES[args.world]:
                mesh = DeviceMesh(device.split(":")[0], torch.arange(args.world).reshape(shape),
                                  mesh_dim_names=("data", "model"))
                # expert parallelism over more than one token shard averages the
                # shards' aux losses (the reference's pmean): weighed 0 there
                profile = TrainProfile(aux_weight=0.0 if cfg.family == "moe" and min(shape) > 1
                                       else TrainProfile().aux_weight)
                if args.rank == 0 and profile.aux_weight not in want:
                    want[profile.aux_weight] = loss_and_grads(model, params, batch, profile, "auto")
                pd = tree_distribute(params, model.param_specs(), mesh, rules)
                kernels.reset_launch_counts()
                counter = CollectiveCounter()
                with counter:
                    loss, grads = loss_and_grads(model, pd, place_batch(batch, mesh, rules),
                                                 profile, "auto", shard=Sharder(mesh, rules))
                counts = kernels.launch_counts()
                loss, grads = float(loss.full_tensor()), tree_full(grads)
                del pd
                if args.rank != 0:
                    continue
                want_loss, want_grads = want[profile.aux_weight]
                where = {}
                grad_rel = chip_smoke._tree_rel(grads, want_grads, where)
                loss_rel = abs(loss - float(want_loss)) / abs(float(want_loss))
                launched = {k: counts[k] for k in need}
                held = (loss_rel <= 1e-5 and grad_rel <= chip_smoke.TRAIN_EXACT_RTOL
                        and (not cuda or all(launched.values())))
                ok &= held
                print(json.dumps({
                    "phase": "sharded_step_ranks", "nvidia_smi": smi, "device": args.device,
                    "world": args.world, "mesh": list(shape), "arch": arch, "family": cfg.family,
                    "layers": cfg.n_layers, "d_model": cfg.d_model, "batch": 4, "seq": seq,
                    "aux_weight": profile.aux_weight,
                    "dtype": "float32", "loss_rel": loss_rel, "grad_max_rel": grad_rel,
                    "grad_worst_leaf": where.get("worst_leaf"),
                    "tolerance": f"loss 1e-5, each gradient leaf {chip_smoke.TRAIN_EXACT_RTOL} of "
                                 "its max-abs",
                    "collectives": {"calls": counter.calls, "input_bytes": counter.bytes},
                    "kernel_launches_rank0": launched, "held": held}), flush=True)
                del grads
            del model, params, want
            if cuda:
                torch.cuda.empty_cache()
    finally:
        dist.destroy_process_group()
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[1])
    ap.add_argument("--world", type=int, default=4, choices=sorted(MESHES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--archs", nargs="*", default=None)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--timeout", type=float, default=600.0)
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
        print(f"sharded_step_ranks: {args.world} ranks need {args.world} cards, "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    if args.device == "cuda":  # once here, not in every rank at once
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import _build

        _build.build_all()
    port = _free_port()
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, __file__, "--world", str(args.world), "--device",
                               args.device, "--seq", str(args.seq), "--rank", str(r), "--port",
                               str(port), "--archs", *args.archs],
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
