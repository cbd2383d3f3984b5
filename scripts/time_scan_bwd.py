#!/usr/bin/env python3
"""Time the scans' backward kernels (``ssd_scan_bwd``, ``rglru_scan_bwd``)
of one checkout on one GPU and fingerprint their outputs, so that two trees
can be compared in one call, bit for bit and in time.

    python3 scripts/time_scan_bwd.py [--tree DIR] [--label NAME] [--case NAME ...]
                                     [--dtype float32|bfloat16] [--yardsticks] [--profile]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` is imported, and its kernels are built into DIR/build; the
cases, the timers and the bounds come from this checkout's ``chip_smoke.py``
(``scan_bwd_case``), so every tree is timed on the same inputs and measured
against the same bound. Only the public wrappers are called:
``ssd_scan_bwd(x, dt, A, B, C, dy, initial_state=, d_final_state=)`` and
``rglru_scan_bwd(a, h, dy, initial_state=, d_final_state=)``, h the f32
states of ``rglru_scan`` on a and b in f32, so any two trees of the port
time the same call. The inputs come from a seeded generator on the card. One JSON line a case and dtype, with NAME and
the card's name and power limit: the SHA-256 of the outputs' bytes (equal
digests: equal outputs, bit for bit), CUDA-event ms a call (median of 20,
the host wrapper included) and device ms a call (20 calls queued behind a
sleep kernel). First a line of the registers and spill bytes that ptxas gave
each kernel of the tree's two builds (``_build.ptxas_report``). A tree
without the backward kernels prints one line saying so. With
``--yardsticks`` each line also carries the plain twin's device ms
(``ssd_bwd_torch`` / ``rglru_bwd_torch``, 3 calls), the forward kernel's
on the same inputs (``ssd_scan`` / ``rglru_scan``, 20 calls) and the bound:
chip_smoke.py's, the larger of the bytes (the inputs read once, the outputs
written once) at the data sheet's rate and the flops (``ssd_bwd_flops``,
the triangular chunk products counted as triangles; 3 a step for rglru) at
the input type's peak. No PyTorch call computes either
gradient, so there is no library yardstick. With ``--profile`` each line
carries the device ms a call of each kernel the wrapper launched
(``torch.profiler`` over 5 calls): for ssd_scan_bwd the C . B, state pass,
adjoint pass, chunk and fold kernels.

Cases (f32 and bf16): chip_smoke.py's SSD_BWD_CASES (mamba2-780m's training
shape (4, 2048, 48, 64), N 128, and a ragged t 389 with an initial state and
a final-state gradient) and RGLRU_BWD_CASES (recurrentgemma-2b's (2, 4096,
2560) and a ragged T 777 with both).

Compare two trees in turns (A, B, B, A, ...) within one call; ``--case``
(repeatable: ``ssd:NAME`` / ``rglru:NAME``) keeps only the named cases,
``--dtype`` one dtype. Needs one GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from time_flash_bwd import kernel_split  # noqa: E402


def digest(tensors):
    return hashlib.sha256(b"".join(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                   for t in tensors if t is not None)).hexdigest()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--case", action="append",
                    help="time only this case, ssd:NAME or rglru:NAME (repeatable)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    help="time only this dtype (default: both)")
    ap.add_argument("--yardsticks", action="store_true",
                    help="also time the plain twins and give the bound")
    ap.add_argument("--profile", action="store_true",
                    help="also give each kernel's device ms a call (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_scan_bwd: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree / "src"))
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    ss = importlib.import_module("repro_torch.kernels.ssd_scan")
    rs = importlib.import_module("repro_torch.kernels.rglru_scan")
    build = importlib.import_module("repro_torch.kernels._build")
    card = smoke.nvidia_smi_line()
    if not hasattr(ss, "ssd_scan_bwd"):
        print(json.dumps({"label": args.label, "nvidia_smi": card,
                          "absent": "this tree has no scan backward kernels"}), flush=True)
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    build.load("ssd_scan_bwd")
    build.load("rglru_scan_bwd")
    print(json.dumps({"label": args.label, "nvidia_smi": card,
                      "ptxas": {n: build.ptxas_report(n) for n in ("ssd_scan_bwd",
                                                                   "rglru_scan_bwd")}}),
          flush=True)
    dtypes = [getattr(torch, args.dtype)] if args.dtype else [torch.float32, torch.bfloat16]
    cases = [("ssd", c) for c in smoke.SSD_BWD_CASES] + \
        [("rglru", c) for c in smoke.RGLRU_BWD_CASES]
    for i, (kind, case) in enumerate(cases):
        if args.case and f"{kind}:{case[0]}" not in args.case:
            continue
        for dtype in dtypes:
            g = torch.Generator(device="cuda").manual_seed(300 + i)
            c = smoke.scan_bwd_case(kind, case, dtype, g)
            call, kernel = c.kernel, f"{kind}_scan_bwd"
            out = call()
            torch.cuda.synchronize()
            rec = {"label": args.label, "nvidia_smi": card, "kernel": kernel, "case": case[0],
                   "dtype": str(dtype).split(".")[1], **c.shape, "initial_state": c.initial,
                   "out_sha256": digest(out), "ms": smoke.time_ms(call, reps=20),
                   "device_ms": smoke.device_ms_per_call(call, n=20)}
            del out
            if args.yardsticks:
                t_bytes, t_ops = c.nbytes / smoke.NOMINAL_BW, c.flops / smoke.PEAK_FLOPS[dtype]
                rec.update({"plain_device_ms": smoke.device_ms_per_call(c.plain, n=3),
                            "forward_device_ms": smoke.device_ms_per_call(c.forward, n=20),
                            "bound_ms": max(t_bytes, t_ops) * 1e3,
                            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                            "bytes": c.nbytes, "flops": c.flops, "library_ms": None})
            if args.profile:
                rec["kernel_device_ms"] = kernel_split(call)
            print(json.dumps(rec), flush=True)
            del c
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
