#!/usr/bin/env python3
"""Time the serving forward of flash_attention (no lse output) of one
checkout on one GPU and fingerprint its outputs, so that two trees can be
compared in one call, bit for bit and in time.

    python3 scripts/time_flash_attention.py [--tree DIR] [--label NAME] [--case NAME ...]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` and its ``chip_smoke.py`` are imported, and its kernels are
built into DIR/build. Only the public wrapper ``flash_attention(q, k, v,
causal=, window=, q_offset=)`` is called, so any two trees of the port time
the same call. The inputs come from a seeded generator on the card, so every
tree gets the same bits. One JSON line a case, with NAME and the card's name
and power limit: the SHA-256 of the output's bytes (equal digests: equal
outputs, bit for bit), CUDA-event ms a call (median of 30, the host wrapper
included) and device ms a call (50 calls queued behind a sleep kernel).
First a line of the registers and spill bytes that ptxas gave each prefill
body of the tree's build (``_build.ptxas_report``), so that two trees'
bodies can be told apart in code as well as in time.

Cases (f32 and bf16): the kernels phase's row 6 shapes, qwen2-0.5b's
prefill (8, 14 / 2, 256, 64) causal, D 256 (2, 10 / 1, 2600, 256) with
window 2048, kimi-k2's D 112 (2, 64 / 8, 512, 112) causal, whisper's encoder
(1, 20 / 20, 1500, 64) non-causal, and llama3.2-1b's training shape (4, 32 /
8, 2048, 64) causal.

Compare two trees in turns (A, B, B, A, ...) within one call; ``--case``
(repeatable) keeps only the named cases, for more turns at one shape. Needs
one GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import sys
from pathlib import Path

import torch

# (name, B, Hq, Hkv, Tq, Tk, D, causal, window)
CASES = (("qwen2_prefill", 8, 14, 2, 256, 256, 64, True, None),
         ("d256_window", 2, 10, 1, 2600, 2600, 256, True, 2048),
         ("d112", 2, 64, 8, 512, 512, 112, True, None),
         ("whisper_encoder", 1, 20, 20, 1500, 1500, 64, False, None),
         ("llama_train", 4, 32, 8, 2048, 2048, 64, True, None))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--case", action="append", choices=[c[0] for c in CASES],
                    help="time only this case (repeatable; default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_attention: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    smoke = importlib.import_module("chip_smoke")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    build = importlib.import_module("repro_torch.kernels._build")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.nvidia_smi_line()
    build.load("flash_attention")
    print(json.dumps({"label": args.label, "nvidia_smi": card, "ptxas": {
        fn: use for fn, use in build.ptxas_report("flash_attention").items()
        if "flash_kernel" in fn or "flash_mma_kernel" in fn}}), flush=True)
    for i, (name, b, hq, hkv, tq, tk, d, causal, window) in enumerate(CASES):
        if args.case and name not in args.case:
            continue
        for dtype in (torch.float32, torch.bfloat16):
            g = torch.Generator(device="cuda").manual_seed(100 + i)
            q, k, v = (torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
                       for h, t in ((hq, tq), (hkv, tk), (hkv, tk)))
            call = lambda: fa.flash_attention(q, k, v, causal=causal, window=window,  # noqa: E731
                                              q_offset=tk - tq if causal else 0)
            out = call()
            torch.cuda.synchronize()
            digest = hashlib.sha256(out.view(torch.uint8).cpu().numpy().tobytes()).hexdigest()
            print(json.dumps({
                "label": args.label, "nvidia_smi": card, "kernel": "flash_attention",
                "case": name, "dtype": str(dtype).split(".")[1], "B": b, "Hq": hq, "Hkv": hkv,
                "Tq": tq, "Tk": tk, "D": d, "causal": causal, "window": window,
                "out_sha256": digest, "ms": smoke.time_ms(call),
                "device_ms": smoke.device_ms_per_call(call, n=50)}), flush=True)
            del q, k, v, out
    return 0


if __name__ == "__main__":
    sys.exit(main())
