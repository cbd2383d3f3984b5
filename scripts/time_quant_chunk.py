#!/usr/bin/env python3
"""Time quant_matmul and the paged chunk kernels of one checkout on one GPU,
with the quantized serve run on them, so that two trees can be compared in
one call.

    python3 scripts/time_quant_chunk.py [--tree DIR] [--label NAME] [--serve-runs N]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` and its ``chip_smoke.py`` are imported, and its kernels are
built into DIR/build. Only public entry points are called (``quant_matmul``,
``paged_flash_prefill_chunk``, ``paged_flash_prefill_chunk_quant``, and
chip_smoke's ``serve_setup`` / ``serve_phase``), so any two trees of the port
time the same calls. Prints one JSON line per measurement, each with NAME and
the card's name and power limit:

  quant_matmul  bf16 x at qwen2-0.5b's MLP shapes, M 8 (decode rows) and 128
                (one chunk), (K, N) = (896, 4864) and (4864, 896), and f32 x
                at M 8, int8 and int4 weights in 128-blocks: CUDA-event ms a
                call (median of 30, host wrapper included), device ms a call
                (50 calls queued behind a sleep kernel), the same two for
                torch.matmul on the dequantized weight in x's type (TF32
                off), and the error against the plain version;
  chunk         bf16 at the serve phase's chunk shape, q (1, 14, 128, 64)
                over a cursor of 256 in pages of 16, dense, int8 and int4
                pools: the same times beside scaled_dot_product_attention
                over the densified (dequantized) cache and the chunk;
  serve_quant   chip_smoke's serve workload (qwen2-0.5b, bf16, int8 MLP
                weights over int8 pages, 16 requests), ``--serve-runs`` runs
                on fresh engines (0: none): step ms p50, tokens/s, chunk ms
                p50.

Compare two trees in turns (A, B, B, A) within one call: serve times move
between calls. Needs one GPU and exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import sys
from pathlib import Path

import torch


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--serve-runs", type=int, default=2)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_quant_chunk: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    smoke = importlib.import_module("chip_smoke")
    from repro_torch.core import QuantizedAccessor, dequantize_array, quantize_array
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import quant_matmul as qmm
    from repro_torch.serving.engine import KV_DTYPES

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.build_all()
    card = smoke.nvidia_smi_line()
    base = {"label": args.label, "tree": str(tree), "card": card}
    emit = lambda rec: print(json.dumps({**base, **rec}), flush=True)
    g = torch.Generator(device="cuda").manual_seed(0)

    def timed(kernel, library):
        return {"ms": smoke.time_ms(kernel), "device_ms": smoke.device_ms_per_call(kernel, n=50),
                "library_ms": smoke.time_ms(library),
                "library_device_ms": smoke.device_ms_per_call(library, n=50)}

    for m, k, n in ((8, 896, 4864), (8, 4864, 896), (128, 896, 4864), (128, 4864, 896)):
        w = torch.randn(n, k, generator=g, device="cuda") / math.sqrt(k)
        x32 = torch.randn(m, k, generator=g, device="cuda")
        for bits in (8, 4):
            acc = QuantizedAccessor(torch.float32, bits=bits, block=128)
            bufs = quantize_array(w, acc)
            qw, sw = bufs["q"], bufs["scale"]
            for dtype in (torch.bfloat16, torch.float32):
                if dtype == torch.float32 and m > 8:
                    continue  # f32 runs the decode rows only (the engine's exactness runs)
                x = x32.to(dtype)
                wdt = dequantize_array(bufs, acc).to(dtype).t()
                kernel = lambda: qmm.quant_matmul(x, qw, sw, bits=bits)
                err = float((kernel().float() -
                             qmm.quant_matmul_torch(x, qw, sw, bits=bits).float()).abs().max())
                emit({"kernel": "quant_matmul", "M": m, "K": k, "N": n, "bits": bits,
                      "dtype": str(dtype).split(".")[1],
                      **timed(kernel, lambda: torch.matmul(x, wdt)), "max_abs_err": err})

    hq, hkv, d, ps, c, cursor = 14, 2, 64, 16, 128, 256
    max_pages = 128
    num = max_pages + 1
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
    kp, vp = rnd(num, hkv, ps, d), rnd(num, hkv, ps, d)
    bt = (torch.randperm(num - 1, generator=g, device="cuda") + 1).reshape(1, max_pages)
    bt = bt.to(torch.int32).contiguous()
    q, ck, cv = rnd(1, hq, c, d), rnd(1, hkv, c, d), rnd(1, hkv, c, d)
    cur = torch.tensor([cursor], dtype=torch.int32, device="cuda")
    s_len = max_pages * ps
    past = torch.arange(s_len, device="cuda")[None, :] < cursor
    tq = torch.arange(c, device="cuda")
    mask = torch.cat([past.expand(c, s_len), tq[None, :] <= tq[:, None]], dim=-1)[None, None]
    for pool in ("dense", "int8", "int4"):
        if pool == "dense":
            kd, vd = smoke.densify(kp, bt), smoke.densify(vp, bt)
            kernel = lambda: pa.paged_flash_prefill_chunk(q, ck, cv, kp, vp, bt, cur)
            plain = lambda: pa.paged_prefill_chunk_torch(q, ck, cv, kp, vp, bt, cur)
        else:
            bits = int(pool[3:])
            spec = KV_DTYPES[pool]
            ke, ve = spec.encode_pages(kp), spec.encode_pages(vp)
            kd = smoke.densify(spec.decode_pages(ke["q"], ke["scale"]).to(torch.bfloat16), bt)
            vd = smoke.densify(spec.decode_pages(ve["q"], ve["scale"]).to(torch.bfloat16), bt)
            args_q = (q, ck, cv, ke["q"], ke["scale"], ve["q"], ve["scale"], bt, cur)
            kernel = lambda: pa.paged_flash_prefill_chunk_quant(*args_q, bits=bits)
            plain = lambda: pa.paged_prefill_chunk_quant_torch(*args_q, bits=bits)
        kk, vv = torch.cat([kd, ck], dim=2), torch.cat([vd, cv], dim=2)
        err = float((kernel().float() - plain().float()).abs().max())
        emit({"kernel": "paged_prefill_chunk" + ("" if pool == "dense" else "_quant"),
              "pool": pool, "q": [1, hq, c, d], "cursor": cursor, "page_size": ps,
              **timed(kernel, lambda: smoke.sdpa(q, kk, vv, mask)), "max_abs_err": err})
    torch.cuda.empty_cache()

    if args.serve_runs > 0:
        smoke.emit = lambda rec: None
        w = smoke.serve_setup(quantized=True, kv_dtype="int8")
        for i in range(args.serve_runs):
            rec = smoke.serve_phase(workload=w, phase="serve_quant", need=smoke.QUANT_PATH)
            emit({"serve_quant_run": i, **{key: rec[key] for key in (
                "step_ms_p50", "step_ms_p95", "tokens_per_s", "chunk_ms_p50", "ttft_s_p95",
                "decode_steps", "launches")}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
