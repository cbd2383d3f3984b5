#!/usr/bin/env python3
"""Time the flash-attention backward (``flash_attention_bwd``) of one
checkout on one GPU and fingerprint its outputs, so that two trees can be
compared in one call, bit for bit and in time.

    python3 scripts/time_flash_bwd.py [--tree DIR] [--label NAME] [--case NAME ...]
                                      [--dtype float32|bfloat16] [--yardsticks] [--profile]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` and its ``chip_smoke.py`` are imported, and its kernels are
built into DIR/build. Only the public wrappers are called: the forward
``flash_attention(q, k, v, causal=, window=, q_offset=, lse=)`` makes out
and lse, then ``flash_attention_bwd(q, k, v, out, dout, lse, causal=,
window=, q_offset=)`` is timed, so any two trees of the port time the same
call. The inputs come from a seeded generator on the card, so every tree
gets the same bits. One JSON line a case and dtype, with NAME and the
card's name and power limit: the SHA-256 of (dq, dk, dv)'s bytes (equal
digests: equal outputs, bit for bit), CUDA-event ms a call (median of 20,
the host wrapper included) and device ms a call (20 calls queued behind a
sleep kernel). First a line of the registers and spill bytes that ptxas gave
each kernel of the tree's flash_attention_bwd build
(``_build.ptxas_report``). With ``--yardsticks`` each line also carries
the plain backward's device ms (``flash_bwd_torch``, 3 calls), the device ms
of SDPA's backward (``torch.autograd.grad`` through
``F.scaled_dot_product_attention``, its graph built once, a band mask for
the window) and the bound: the larger of chip_smoke.py's two times, 2.5x
the forward's flops over the live pairs at the dtype's peak and the bytes of
q, k, v, out, dO, lse, dq, dk, dv at the data sheet's rate. With
``--profile`` each line carries the device ms a call of each kernel the
wrapper launched (``torch.profiler`` over 5 calls), so the time can be split
between the dQ, dK/dV and fold kernels.

Cases (f32 and bf16): chip_smoke.py's BWD_CASES, llama3.2-1b's training
shape (4, 32 / 8, 2048, 64) causal, (2, 16 / 2, 1024, 128) causal, a 64-key
window at (2, 32 / 8, 1024, 64), whisper's cross shape (4, 20 / 20, 448
against 1500, 64) non-causal and (1, 8 / 1, 512, 256) causal; and the
ragged (1, 12 / 4, 777, 128) causal with q_offset a tensor.

Compare two trees in turns (A, B, B, A, ...) within one call; ``--case``
(repeatable) keeps only the named cases, ``--dtype`` one dtype. Needs one
GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib
import json
import re
import sys
from pathlib import Path

import torch

# (name, B, Hq, Hkv, Tq, Tk, D, causal, window); q_offset Tk - Tq when causal
CASES = (("llama3.2-1b", 4, 32, 8, 2048, 2048, 64, True, None),
         ("d128", 2, 16, 2, 1024, 1024, 128, True, None),
         ("window64", 2, 32, 8, 1024, 1024, 64, True, 64),
         ("whisper_cross", 4, 20, 20, 448, 1500, 64, False, None),
         ("d256", 1, 8, 1, 512, 512, 256, True, None),
         ("ragged_d128", 1, 12, 4, 777, 777, 128, True, None))
TENSOR_OFFSET = {"ragged_d128"}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--case", action="append", choices=[c[0] for c in CASES],
                    help="time only this case (repeatable; default: all)")
    ap.add_argument("--dtype", choices=["float32", "bfloat16"],
                    help="time only this dtype (default: both)")
    ap.add_argument("--yardsticks", action="store_true",
                    help="also time the plain backward and SDPA's, and give the bound")
    ap.add_argument("--profile", action="store_true",
                    help="also give each kernel's device ms a call (torch.profiler)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_flash_bwd: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    smoke = importlib.import_module("chip_smoke")
    fa = importlib.import_module("repro_torch.kernels.flash_attention")
    fv = importlib.import_module("repro_torch.kernels.flash_vjp")
    build = importlib.import_module("repro_torch.kernels._build")
    torch.backends.cuda.matmul.allow_tf32 = False
    card = smoke.nvidia_smi_line()
    build.load("flash_attention_bwd")
    print(json.dumps({"label": args.label, "nvidia_smi": card,
                      "ptxas": build.ptxas_report("flash_attention_bwd")}), flush=True)
    dtypes = [getattr(torch, args.dtype)] if args.dtype else [torch.float32, torch.bfloat16]
    for i, (name, b, hq, hkv, tq, tk, d, causal, window) in enumerate(CASES):
        if args.case and name not in args.case:
            continue
        off = tk - tq if causal else 0
        for dtype in dtypes:
            g = torch.Generator(device="cuda").manual_seed(200 + i)
            q, k, v, do = (torch.randn(b, h, t, d, generator=g, device="cuda").to(dtype)
                           for h, t in ((hq, tq), (hkv, tk), (hkv, tk), (hq, tq)))
            lse = torch.empty((b, hq, tq), dtype=torch.float32, device="cuda")
            out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off,
                                     lse=lse)
            q_off = (torch.tensor(off, dtype=torch.int32, device="cuda")
                     if name in TENSOR_OFFSET else off)
            call = lambda: fv.flash_attention_bwd(q, k, v, out, do, lse,  # noqa: E731
                                                  causal=causal, window=window, q_offset=q_off)
            grads = call()
            torch.cuda.synchronize()
            digest = hashlib.sha256(b"".join(
                t.contiguous().view(torch.uint8).cpu().numpy().tobytes() for t in grads)
            ).hexdigest()
            del grads
            rec = {
                "label": args.label, "nvidia_smi": card, "kernel": "flash_attention_bwd",
                "case": name, "dtype": str(dtype).split(".")[1], "B": b, "Hq": hq,
                "Hkv": hkv, "Tq": tq, "Tk": tk, "D": d, "causal": causal, "window": window,
                "out_sha256": digest, "ms": smoke.time_ms(call, reps=20),
                "device_ms": smoke.device_ms_per_call(call, n=20)}
            if args.yardsticks:
                rec.update(yardsticks(smoke, fv, q, k, v, out, do, lse, causal, window, off))
            if args.profile:
                rec["kernel_device_ms"] = kernel_split(call)
            print(json.dumps(rec), flush=True)
            del q, k, v, do, lse, out
            torch.cuda.empty_cache()
    return 0


def kernel_split(call, n=5):
    """Device ms a call of each CUDA kernel ``call`` launches."""
    from torch.profiler import ProfilerActivity, profile

    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            call()
        torch.cuda.synchronize()
    out = {}
    for ev in prof.key_averages():
        if ev.device_time_total > 0:  # the name without its namespace and arguments
            m = re.search(r"(\w+(?:<[^<>()]*>)?)\(", ev.key)
            out[m.group(1) if m else ev.key[:60]] = ev.device_time_total / 1e3 / n
    return out


def yardsticks(smoke, fv, q, k, v, out, do, lse, causal, window, off):
    """The plain backward's and SDPA's backward's device ms, and the bound."""
    import torch.nn.functional as F

    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    plain = lambda: fv.flash_bwd_torch(q, k, v, out, do, lse, causal=causal,  # noqa: E731
                                       window=window, q_offset=off)
    qs, ks, vs = (t.detach().clone().requires_grad_() for t in (q, k, v))
    mask = None
    if window is not None:
        qp = torch.arange(tq, device="cuda")[:, None] + off
        kp = torch.arange(tk, device="cuda")[None, :]
        mask = (kp <= qp) & (kp > qp - window)
    lib_out = F.scaled_dot_product_attention(
        qs, ks, vs, attn_mask=mask, is_causal=causal and mask is None and tq == tk,
        enable_gqa=hq != hkv)
    library = lambda: torch.autograd.grad(lib_out, (qs, ks, vs), do,  # noqa: E731
                                          retain_graph=True)
    live = smoke._causal_keys(tq, tk, off, window) if causal else tq * tk
    esz = q.element_size()
    nbytes = (2 * q.numel() + 2 * k.numel() + 2 * v.numel() + out.numel() + do.numel()) * esz \
        + lse.numel() * 4
    t_bytes = nbytes / smoke.NOMINAL_BW
    t_ops = 2.5 * 4 * b * hq * live * d / smoke.PEAK_FLOPS[q.dtype]
    return {"plain_device_ms": smoke.device_ms_per_call(plain, n=3),
            "library_device_ms": smoke.device_ms_per_call(library, n=10),
            "bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


if __name__ == "__main__":
    sys.exit(main())
