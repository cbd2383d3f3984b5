#!/usr/bin/env python3
"""End-to-end proof that the PyTorch/CUDA port (src/repro_torch) serves on one
NVIDIA GPU, on its own hand-written kernels.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout's sources (nvcc, into build/, one
process per source, all at once), then runs these phases, each printing JSON
lines; any failure raises and exits non-zero:

  device        GPU name and power limit, torch/CUDA versions, kernel build
                time, and the device-to-device copy bandwidth the bounds use.
  kernels       each kernel against its plain PyTorch version at the serving
                path's shapes (Hq 14, Hkv 2, D 64, page 16, B 8, and the serve
                phase's one-row 128-token chunk; the quantized attention over
                int8 and int4 pools; quant_matmul at the MLP's decode and
                chunk shapes, int8 and int4 weights), in f32
                (tolerance 2e-5) and bf16 (within one bf16 ulp of the plain
                output plus the f32 tolerance 2e-5, for outputs near 0 whose
                bf16 spacing is finer than f32 sums resolve): error, kernel
                ms, plain ms, bound ms, and one PyTorch call computing the
                same function as a yardstick (scaled_dot_product_attention
                over the densified, dequantized cache; torch.matmul on the
                dequantized weight), timed here only: the port never calls it.
  engine_exact  qwen2-0.5b at full width in f32, random weights from a
                seeded generator: six requests through ServeEngine with
                monolithic and with chunked prefill, a pool small enough to
                preempt; greedy tokens must equal an unbatched Model.forward
                recompute. Run twice: at 2 layers with the reference's init,
                and at all 24 layers with the attention projections rescaled
                to their true fan-in (see condition_attention). Before it,
                three lines measure how far two plain computations of the
                same logits drift apart: the reference's init is chaotic at
                24 layers, the rescaled one is not.
  engine_exact_quant
                the same requests with int8 MLP weights (build_model(...,
                quantized=True)) over int8 and int4 KV pages: greedy tokens of
                the engine on the card (kernels) must equal the same engine
                with the same weights on the CPU (plain versions), in both
                prefill modes, at 2 layers (reference init) and, for int8 KV,
                at 24 layers (rescaled; 8 new tokens a request, as the CPU
                engine takes about a minute a mode at that depth). All three
                quantized kernels launch.
  serve         the same model in bf16, chunked prefill, prefix sharing,
                max_batch 8, 16 requests, three runs on fresh engines:
                tokens/s, step and chunk times, TTFT, then a serve_summary
                line. Launch counts are zeroed just before and read just
                after each run (the serving path), and both attention
                kernels must have launched; the kernels line reports the
                first run's.
  serve_quant   the serve workload with int8 MLP weights over int8, then
                int4, KV pages, one run each, counts zeroed just before and
                read just after; the three quantized kernels must have
                launched, and the int8 pool must be >= 1.9x smaller than the
                bf16 one. The kernels line reports the int8 run's counts.
  paper         the paper-suite kernels behind the mdspan layout dispatch
                (sum3d, stencil3d, tinymatsum static and dynamic, matvec
                right and left), each against its plain version at the
                reference's sizes (96^3, N 100k/200k of 3x3, 2048^2) and at
                HBM-filling ones (512^3, N 8M, 16384^2), sum3d and
                tinymatsum in bf16 too, with a library call as yardstick
                (torch.sum, torch.add, torch.mv, conv3d + pad); sum3d must
                repeat bit for bit, and runs at a ragged size too (95x97x99,
                509x511x513) on inputs of mean 1. Then the zero-overhead comparison
                (ops.sum3d / ops.matvec on an MdSpan against the raw kernel
                call: host us and device ms per call, printed, not gated),
                and the main path: the ops dispatchers on MdSpans at the
                HBM sizes, counts zeroed just before and read just after,
                every output checked against its plain version and every
                kernel launched. Tolerances: sum3d 1e-5 * sum(|x|), stencil
                1e-4, tinymatsum 1e-6 (bf16 2e-2), matvec 1e-5 *
                sum_j |A_ij v_j| per row (sums of up to 16384 terms).
  kernels line  {"kernels": [...]} with each ported kernel's numbers, plus the
                TPU kernels still to be ported.

Then the card's name and power limit as nvidia-smi prints them, and as the
last line {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
It needs one GPU and exits non-zero without one (or without the repo).
"""
from __future__ import annotations

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SERVE_RUNS = 3  # serve runs in one process: the host-bound metrics spread from run to run
NOMINAL_BW = 3.35e12  # H100 SXM HBM3, bytes/s (data sheet)
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}  # dense, data sheet
ATTN_SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
PAPER_SOURCE = "src/repro_torch/kernels/csrc/paper_suite.cu"
PORTED = {  # kernel -> (the TPU kernel it replaces, its source)
    "paged_decode": ("src/repro/kernels/paged_attention.py:151", ATTN_SOURCE),
    "paged_prefill_chunk": ("src/repro/kernels/paged_attention.py:575", ATTN_SOURCE),
    "paged_decode_quant": ("src/repro/kernels/paged_attention.py:387", ATTN_SOURCE),
    "paged_prefill_chunk_quant": ("src/repro/kernels/paged_attention.py:756", ATTN_SOURCE),
    "quant_matmul": ("src/repro/kernels/quant_matmul.py:57",
                     "src/repro_torch/kernels/csrc/quant_matmul.cu"),
    "sum3d": ("src/repro/kernels/sum3d.py:37", PAPER_SOURCE),
    "stencil3d": ("src/repro/kernels/stencil3d.py:59", PAPER_SOURCE),
    "tinymatsum_static": ("src/repro/kernels/tinymatsum.py:34", PAPER_SOURCE),
    "tinymatsum_dynamic": ("src/repro/kernels/tinymatsum.py:65", PAPER_SOURCE),
    "matvec_right": ("src/repro/kernels/matvec.py:33", PAPER_SOURCE),
    "matvec_left": ("src/repro/kernels/matvec.py:64", PAPER_SOURCE),
}
DENSE_PATH = ("paged_decode", "paged_prefill_chunk")
QUANT_PATH = ("paged_decode_quant", "paged_prefill_chunk_quant", "quant_matmul")
PAPER_PATH = ("sum3d", "stencil3d", "tinymatsum_static", "tinymatsum_dynamic", "matvec_right",
              "matvec_left")
NOT_PORTED = [
    ("flash_attention", "src/repro/kernels/flash_attention.py:104"),
    ("flash_decode", "src/repro/kernels/flash_attention.py:222"),
    ("ssd_scan", "src/repro/kernels/ssd_scan.py:85"),
    ("rglru_scan", "src/repro/kernels/rglru_scan.py:50"),
]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def time_ms(fn, reps: int = 30, warmup: int = 3) -> float:
    """Median over ``reps`` of one call timed with CUDA events."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def copy_bandwidth() -> float:
    """Device-to-device copy rate (bytes read + written per second) of a
    1 GiB buffer."""
    n = 1 << 28
    src = torch.empty(n, dtype=torch.float32, device="cuda").uniform_()
    dst = torch.empty_like(src)
    ms = time_ms(lambda: dst.copy_(src), reps=10)
    return 2 * src.numel() * 4 / (ms * 1e-3)


# =====================================================================================
# phase: kernels
# =====================================================================================
BF16_ATOL = 2e-5  # the f32 tolerance: near 0 the bf16 spacing is finer than f32 sums resolve


def bf16_excess(got: torch.Tensor, want: torch.Tensor):
    """(largest |got - want| in bf16 ulps of want, largest |got - want| minus
    (1 ulp + BF16_ATOL)): the second is <= 0 when every element is within one
    bf16 ulp of the plain output plus the f32 tolerance."""
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)  # bf16: 8 significant bits
    d = (got.float() - w).abs()
    return float((d / ulp).max()), float((d - ulp - BF16_ATOL).max())


def check_and_time(name, dtype, kernel, plain, library, nbytes, flops, bw, case,
                   tolerance=None, phase="kernels"):
    """One kernel against its plain version on the same inputs, then timed
    beside the plain version and the library call; ``tolerance(got, want)``
    -> (ok, description) replaces the default f32 / bf16 rule."""
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    if tolerance is not None:
        ok, tol = tolerance(got, want)
        extra = {}
    elif dtype == torch.float32:
        ok = bool(torch.allclose(got, want, rtol=2e-5, atol=2e-5))
        tol = "allclose rtol=atol=2e-5"
        extra = {}
    else:
        ulps, excess = bf16_excess(got, want)
        ok = excess <= 0.0
        tol = f"<= 1 bf16 ulp of the plain output + {BF16_ATOL}, elementwise"
        extra = {"max_bf16_ulps": ulps}
    t_bytes, t_ops = nbytes / bw, flops / PEAK_FLOPS[dtype]
    rec = {
        "phase": phase, "kernel": name, "dtype": str(dtype).split(".")[1], **case,
        "max_abs_err": err, "tolerance": tol, "ok": ok, **extra,
        "ms": time_ms(kernel), "plain_ms": time_ms(plain, reps=5),
        "library_ms": time_ms(library, reps=10),
        "bound_ms": max(t_bytes, t_ops) * 1e3,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "bound_ms_nominal_bw": max(nbytes / NOMINAL_BW, t_ops) * 1e3,
        "bytes": nbytes, "flops": flops,
    }
    emit(rec)
    if not ok:
        raise AssertionError(f"{name} {case} disagrees with its plain version: {rec}")
    return rec


def densify(pool, tables):
    b, mp = tables.shape
    _, hkv, ps, d = pool.shape
    return pool[tables.long()].transpose(1, 2).reshape(b, hkv, mp * ps, d)


def sdpa(q, k, v, mask):
    import torch.nn.functional as F

    return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, enable_gqa=True)


def kernel_phase(bw):
    """Every kernel against its plain version at the serving shapes; returns
    kernel name -> the record the kernels line reports (bf16 at the serve
    phase's shapes; int8 pools and weights for the quantized kernels)."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.serving.engine import KV_DTYPES

    g = torch.Generator(device="cuda").manual_seed(0)
    B, HQ, HKV, D, PS, MAXP = 8, 14, 2, 64, 16, 128
    NUM = B * MAXP + 1
    lens = [0, 1, 16, 100, 517, 1024, 1500, 2048]  # a length-0 row, exactly one page
    # chunk C in {16, 256, 5} at B 8 with cursors 0 and > 0, and the serve
    # phase's own shape (one row, a 128-token chunk)
    chunk_cases = ((16, [0, 16, 64, 256, 512, 1024, 1536, 1792]),
                   (256, [0, 0, 128, 256, 512, 1024, 1280, 1792]),
                   (5, [0, 3, 17, 100, 517, 1024, 1500, 2000]),
                   (128, [256]))
    quant_chunk_cases = {128, 256}
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.tensor([], dtype=dtype).element_size()
        rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
        kp, vp = rnd(NUM, HKV, PS, D), rnd(NUM, HKV, PS, D)
        perm = torch.randperm(NUM - 1, generator=g, device="cuda") + 1
        bt = perm.reshape(B, MAXP).to(torch.int32).contiguous()
        # the same values as int8 and int4 pages (the engine's encoding), and
        # their dequantized densified caches for the library yardstick
        quant = {}
        for bits in (8, 4):
            spec = KV_DTYPES[f"int{bits}"]
            kq, vq = spec.encode_pages(kp), spec.encode_pages(vp)
            quant[bits] = (kq["q"], kq["scale"], vq["q"], vq["scale"],
                           densify(spec.decode_pages(kq["q"], kq["scale"]).to(dtype), bt),
                           densify(spec.decode_pages(vq["q"], vq["scale"]).to(dtype), bt),
                           spec.packed_dim(D))
        kd, vd = densify(kp, bt), densify(vp, bt)
        # decode
        q = rnd(B, HQ, 1, D)
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        live = torch.arange(MAXP * PS, device="cuda")[None, :] < cl[:, None]
        mask = live[:, None, None, :]
        tokens = sum(lens)
        live_pages = sum(-(-n // PS) for n in lens)
        small = 2 * q.numel() * esz + bt.numel() * 4 + B * 4  # q, out, tables, lengths
        case = {"B": B, "Hq": HQ, "Hkv": HKV, "D": D, "page_size": PS, "lens": lens}
        rec = check_and_time(
            "paged_decode", dtype,
            lambda: pa.paged_flash_decode(q, kp, vp, bt, cl),
            lambda: pa.paged_decode_attention_torch(q, kp, vp, bt, cl),
            lambda: sdpa(q, kd, vd, mask),
            small + 2 * tokens * HKV * D * esz, 4 * tokens * HQ * D, bw, case,
        )
        if dtype == torch.bfloat16:
            main["paged_decode"] = rec
        for bits, (kq, ks, vq, vs, kdq, vdq, dq) in quant.items():
            rec = check_and_time(
                "paged_decode_quant", dtype,
                lambda: pa.paged_flash_decode_quant(q, kq, ks, vq, vs, bt, cl, bits=bits),
                lambda: pa.paged_decode_attention_quant_torch(q, kq, ks, vq, vs, bt, cl,
                                                              bits=bits),
                lambda: sdpa(q, kdq, vdq, mask),
                small + 2 * tokens * HKV * dq + 2 * live_pages * HKV * 4,
                4 * tokens * HQ * D, bw, {**case, "bits": bits},
            )
            if dtype == torch.bfloat16 and bits == 8:
                main["paged_decode_quant"] = rec
        for c, cursors in chunk_cases:
            nb = len(cursors)
            btc = bt[:nb].contiguous()
            qc, ck, cv = rnd(nb, HQ, c, D), rnd(nb, HKV, c, D), rnd(nb, HKV, c, D)
            cur = torch.tensor(cursors, dtype=torch.int32, device="cuda")
            s = MAXP * PS
            past = torch.arange(s, device="cuda")[None, None, :] < cur[:, None, None]
            tq = torch.arange(c, device="cuda")
            present = (tq[None, :] <= tq[:, None])[None].expand(nb, c, c)
            cmask = torch.cat([past.expand(nb, c, s), present], dim=-1)[:, None]
            keys = sum(cur_b * c + c * (c + 1) // 2 for cur_b in cursors)
            small = ((2 * qc.numel() + ck.numel() + cv.numel()) * esz + btc.numel() * 4
                     + nb * 4)
            case = {"B": nb, "Hq": HQ, "Hkv": HKV, "D": D, "page_size": PS, "C": c,
                    "cursors": cursors}
            rec = check_and_time(
                "paged_prefill_chunk", dtype,
                lambda: pa.paged_flash_prefill_chunk(qc, ck, cv, kp, vp, btc, cur),
                lambda: pa.paged_prefill_chunk_torch(qc, ck, cv, kp, vp, btc, cur),
                lambda: sdpa(qc, torch.cat([kd[:nb], ck], dim=2),
                             torch.cat([vd[:nb], cv], dim=2), cmask),
                small + 2 * sum(cursors) * HKV * D * esz, 4 * keys * HQ * D, bw, case,
            )
            if dtype == torch.bfloat16 and c == 128:
                main["paged_prefill_chunk"] = rec
            if c not in quant_chunk_cases:
                continue
            past_pages = sum(-(-n // PS) for n in cursors)
            for bits, (kq, ks, vq, vs, kdq, vdq, dq) in quant.items():
                kk = torch.cat([kdq[:nb], ck], dim=2)
                vv = torch.cat([vdq[:nb], cv], dim=2)
                rec = check_and_time(
                    "paged_prefill_chunk_quant", dtype,
                    lambda: pa.paged_flash_prefill_chunk_quant(qc, ck, cv, kq, ks, vq, vs, btc,
                                                               cur, bits=bits),
                    lambda: pa.paged_prefill_chunk_quant_torch(qc, ck, cv, kq, ks, vq, vs, btc,
                                                               cur, bits=bits),
                    lambda: sdpa(qc, kk, vv, cmask),
                    small + 2 * sum(cursors) * HKV * dq + 2 * past_pages * HKV * 4,
                    4 * keys * HQ * D, bw, {**case, "bits": bits},
                )
                if dtype == torch.bfloat16 and c == 128 and bits == 8:
                    main["paged_prefill_chunk_quant"] = rec
    main["quant_matmul"] = quant_matmul_checks(bw, g)
    torch.cuda.synchronize()
    return main


def quant_matmul_checks(bw, g):
    """quant_matmul at the MLP's serve shapes: M = 8 decode rows and one
    128-token chunk, (K, N) = (896, 4864) for w_gate/w_up and (4864, 896) for
    w_down, int8 and int4 weights in 128-blocks; returns the bf16 int8 record
    of the decode w_gate/w_up shape."""
    from repro_torch.core import QuantizedAccessor, dequantize_array, quantize_array
    from repro_torch.kernels import quant_matmul as qmm

    out = None
    for m, k, n in ((8, 896, 4864), (8, 4864, 896), (128, 896, 4864), (128, 4864, 896)):
        w = torch.randn(n, k, generator=g, device="cuda") / math.sqrt(k)
        for bits in (8, 4):
            acc = QuantizedAccessor(torch.float32, bits=bits, block=128)
            bufs = quantize_array(w, acc)
            qw, sw = bufs["q"], bufs["scale"]
            for dtype in (torch.float32, torch.bfloat16):
                esz = torch.tensor([], dtype=dtype).element_size()
                x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
                wd = dequantize_array(bufs, acc).to(dtype)
                rec = check_and_time(
                    "quant_matmul", dtype,
                    lambda: qmm.quant_matmul(x, qw, sw, bits=bits),
                    lambda: qmm.quant_matmul_torch(x, qw, sw, bits=bits),
                    lambda: torch.matmul(x, wd.t()),
                    (m * k + m * n) * esz + qw.numel() + sw.numel() * 4, 2 * m * n * k, bw,
                    {"M": m, "K": k, "N": n, "bits": bits, "qblock": 128},
                )
                if (m, k, bits, dtype) == (8, 896, 8, torch.bfloat16):
                    out = rec
    return out


# =====================================================================================
# phase: paper (the paper-suite kernels behind the mdspan layout dispatch)
# =====================================================================================
PAPER_SIZES = {  # the reference's own (its benchmarks and tests), and HBM-filling ones
    "reference": dict(cube=96, ragged=(95, 97, 99), tiny_n=(100_000, 200_000), mat=2048),
    "hbm": dict(cube=512, ragged=(509, 511, 513), tiny_n=(8_000_000,), mat=16384),
}  # ragged: a sum3d size that is no multiple of the first pass's unrolled stride
TINY_JK = (3, 3)  # the paper's tiny matrices


def _allclose(rtol, atol):
    def tolerance(got, want):
        ok = bool(torch.allclose(got.float(), want.float(), rtol=rtol, atol=atol))
        return ok, f"allclose rtol={rtol} atol={atol}"
    return tolerance


def _sum_tolerance(x):
    """A sum of ~1e8 terms differs from another order's by rounding that grows
    with the terms' magnitudes: |got - want| <= 1e-5 * sum(|x|). The inputs
    (``_sum_input``) have mean 1, so sum(|x|) is close to the sum itself and
    the bound is relative: a lost block partial (1/1024 of it) fails."""
    bound = 1e-5 * float(x.float().abs().sum())

    def tolerance(got, want):
        return abs(float(got) - float(want)) <= bound, f"|got - want| <= 1e-5 * sum(|x|) = {bound}"
    return tolerance


def _row_tolerance(a, v):
    """matvec: each y_i is a sum of J products, whose rounding in another
    order grows with their magnitudes: |got_i - want_i| <= 1e-5 *
    sum_j |A_ij v_j| (the sum3d rule, row by row)."""
    bound = 1e-5 * (a.float().abs() @ v.float().abs())

    def tolerance(got, want):
        ok = bool(((got.float() - want.float()).abs() <= bound).all())
        return ok, "|got_i - want_i| <= 1e-5 * sum_j |A_ij v_j|"
    return tolerance


def _randn(g, *shape, dtype=torch.float32):
    return torch.randn(*shape, generator=g, device=g.device).to(dtype)


def _sum_input(g, *shape, dtype=torch.float32):
    """Normal values of mean 1 and variance 1 (signs mixed), for the sums."""
    return (torch.randn(*shape, generator=g, device=g.device) + 1.0).to(dtype)


def paper_checks(bw, label, g):
    """Each paper-suite kernel against its plain version at one size set
    (PAPER_SIZES[label]), timed beside it and a library call: sum3d and
    tinymatsum in f32 and bf16, stencil3d and matvec (both layouts) in f32.
    sum3d must also repeat bit for bit, and is checked at a ragged size too.
    Returns the f32 record of each kernel (tinymatsum: the last N)."""
    import torch.nn.functional as F
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import stencil3d as st
    from repro_torch.kernels import sum3d as sm
    from repro_torch.kernels import tinymatsum as tm

    sizes = PAPER_SIZES[label]
    recs = {}
    n3 = sizes["cube"]
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.tensor([], dtype=dtype).element_size()
        xr = _sum_input(g, *sizes["ragged"], dtype=dtype)
        check_and_time("sum3d", dtype, lambda: sm.sum3d(xr), lambda: sm.sum3d_torch(xr),
                       lambda: torch.sum(xr, dtype=torch.float32), xr.numel() * esz + 4,
                       xr.numel(), bw, {"sizes": label, "shape": list(sizes["ragged"])},
                       tolerance=_sum_tolerance(xr), phase="paper")
        del xr
        x = _sum_input(g, n3, n3, n3, dtype=dtype)
        case = {"sizes": label, "shape": [n3] * 3}
        rec = check_and_time("sum3d", dtype, lambda: sm.sum3d(x), lambda: sm.sum3d_torch(x),
                             lambda: torch.sum(x, dtype=torch.float32), x.numel() * esz + 4,
                             x.numel(), bw, case, tolerance=_sum_tolerance(x), phase="paper")
        first, second = sm.sum3d(x), sm.sum3d(x)
        same = torch.equal(first, second)
        emit({"phase": "paper", "check": "sum3d_repeats_bit_for_bit", "sizes": label,
              "dtype": str(dtype).split(".")[1], "values": [float(first), float(second)],
              "equal": same})
        if not same:
            raise AssertionError(f"sum3d gave two results on one input: {first} {second}")
        if dtype == torch.float32:
            recs["sum3d"] = rec
            ones = torch.ones(1, 1, 3, 3, 3, device=x.device)
            recs["stencil3d"] = check_and_time(
                "stencil3d", dtype, lambda: st.stencil3d(x), lambda: st.stencil3d_torch(x),
                lambda: F.pad(F.conv3d(x[None, None], ones)[0, 0], (1, 1, 1, 1, 1, 1)),
                2 * x.numel() * esz, 26 * (n3 - 2) ** 3, bw, case,
                tolerance=_allclose(1e-4, 1e-4), phase="paper")
        del x
        for n in sizes["tiny_n"]:
            o, s = _randn(g, n, *TINY_JK, dtype=dtype), _randn(g, n, *TINY_JK, dtype=dtype)
            tol = 1e-6 if dtype == torch.float32 else 2e-2
            for name, fn in (("tinymatsum_static", tm.tinymatsum_static),
                             ("tinymatsum_dynamic", tm.tinymatsum_dynamic)):
                rec = check_and_time(
                    name, dtype, lambda: fn(o, s), lambda: tm.tinymatsum_torch(o, s),
                    lambda: torch.add(o, s), 3 * o.numel() * esz, o.numel(), bw,
                    {"sizes": label, "N": n, "J": TINY_JK[0], "K": TINY_JK[1]},
                    tolerance=_allclose(tol, tol), phase="paper")
                if dtype == torch.float32:
                    recs[name] = rec
            del o, s
    m = sizes["mat"]
    a, v = _randn(g, m, m), _randn(g, m)
    at = a.t().contiguous()  # the same A stored column-major
    for name, kernel, library in (
            ("matvec_right", lambda: mv.matvec_right(a, v), lambda: torch.mv(a, v)),
            ("matvec_left", lambda: mv.matvec_left(at, v), lambda: torch.mv(at.t(), v))):
        recs[name] = check_and_time(
            name, torch.float32, kernel, lambda: mv.matvec_torch(a, v), library,
            (m * m + 2 * m) * 4, 2 * m * m, bw, {"sizes": label, "I": m, "J": m},
            tolerance=_row_tolerance(a, v), phase="paper")
    emit({"phase": "paper", "check": "matvec_right_over_left", "sizes": label,
          "ms_ratio": recs["matvec_right"]["ms"] / recs["matvec_left"]["ms"]})
    return recs


def device_ms_per_call(fn, n=100, sleep_cycles=50_000_000):
    """Device time per call of ``fn``: ``n`` calls enqueued behind a sleep
    kernel, so the device runs them back to back however slow the host is."""
    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(sleep_cycles)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def zero_overhead_check(g, reps=50):
    """The paper's zero-overhead claim: ops.sum3d / ops.matvec on an MdSpan
    (built by MdSpan.from_dense inside the call) against the same kernel
    called on the raw buffer, LayoutRight and LayoutLeft, at the reference's
    sizes. Host microseconds per call, alternating the two in one loop (a
    synchronize before each timed call), and device ms per call. Both must
    launch the same kernel; the times are printed, not gated."""
    from repro_torch import kernels
    from repro_torch.core import Extents, LayoutLeft, LayoutRight, MdSpan
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import ops
    from repro_torch.kernels import sum3d as sm

    n3, m = PAPER_SIZES["reference"]["cube"], PAPER_SIZES["reference"]["mat"]
    E = Extents.fully_dynamic
    x_right = _randn(g, n3, n3, n3)
    x_left = _randn(g, n3, n3, n3).permute(2, 1, 0)  # logical view of column-major storage
    a_right, v = _randn(g, m, m), _randn(g, m)
    a_left = _randn(g, m, m).t()
    def span(t, layout):
        return MdSpan.from_dense(t, layout=layout(E(*t.shape)))

    pairs = {  # (kernel, layout) -> (the call through an MdSpan, the raw kernel call)
        ("sum3d", "right"): (lambda: ops.sum3d(span(x_right, LayoutRight)),
                             lambda: sm.sum3d(x_right)),
        ("sum3d", "left"): (lambda: ops.sum3d(span(x_left, LayoutLeft)),
                            lambda: sm.sum3d(x_left.permute(2, 1, 0))),
        ("matvec", "right"): (lambda: ops.matvec(span(a_right, LayoutRight), v),
                              lambda: mv.matvec_right(a_right, v)),
        ("matvec", "left"): (lambda: ops.matvec(span(a_left, LayoutLeft), v),
                             lambda: mv.matvec_left(a_left.t(), v)),
    }
    out = []
    for (kernel, layout), (via_mdspan, raw) in pairs.items():
        counts = []
        for fn in (via_mdspan, raw):
            kernels.reset_launch_counts()
            fn()
            counts.append(kernels.launch_counts())
        torch.cuda.synchronize()
        host = {"mdspan": [], "raw": []}
        for _ in range(reps):
            for key, fn in (("mdspan", via_mdspan), ("raw", raw)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                host[key].append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        mds_us, raw_us = statistics.median(host["mdspan"]), statistics.median(host["raw"])
        rec = {"phase": "paper_zero_overhead", "kernel": kernel, "layout": layout,
               "same_kernel": counts[0] == counts[1] and sum(counts[0].values()) == 1,
               "host_us_mdspan": mds_us, "host_us_raw": raw_us, "host_us_diff": mds_us - raw_us,
               "device_ms_mdspan": device_ms_per_call(via_mdspan),
               "device_ms_raw": device_ms_per_call(raw), "reps": reps}
        emit(rec)
        if not rec["same_kernel"]:
            raise AssertionError(f"the MdSpan and raw calls launched different kernels: {counts}")
        out.append(rec)
    return out


def paper_main_path(g, label="hbm"):
    """The paper-suite path as a user drives it, at PAPER_SIZES[label]: the
    ops dispatchers on MdSpans (sum3d and matvec, LayoutRight and LayoutLeft
    over existing storage) and on tensors (stencil3d, tinymatsum static and
    dynamic), launch counts zeroed just before and read just after. Every
    output must agree with its plain version and every kernel must have
    launched. Returns the launch counts."""
    from repro_torch import kernels
    from repro_torch.core import Extents, LayoutLeft, LayoutRight, MdSpan
    from repro_torch.kernels import matvec as mv
    from repro_torch.kernels import ops
    from repro_torch.kernels import stencil3d as st
    from repro_torch.kernels import sum3d as sm
    from repro_torch.kernels import tinymatsum as tm

    sizes = PAPER_SIZES[label]
    E = Extents.fully_dynamic
    n3, n, m = sizes["cube"], sizes["tiny_n"][-1], sizes["mat"]
    x = _sum_input(g, n3, n3, n3)
    x_left = _sum_input(g, n3, n3, n3).permute(2, 1, 0)  # logical view of column-major storage
    o, s = _randn(g, n, *TINY_JK), _randn(g, n, *TINY_JK)
    a, v = _randn(g, m, m), _randn(g, m)
    a_left = _randn(g, m, m).t()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    out = {
        "sum3d_right": ops.sum3d(MdSpan.from_dense(x, layout=LayoutRight(E(n3, n3, n3)))),
        "sum3d_left": ops.sum3d(MdSpan.from_dense(x_left, layout=LayoutLeft(E(n3, n3, n3)))),
        "stencil3d": ops.stencil3d(x),
        "tinymatsum_static": ops.tinymatsum(o, s, static_extents=True),
        "tinymatsum_dynamic": ops.tinymatsum(o, s, static_extents=False),
        "matvec_right": ops.matvec(MdSpan.from_dense(a, layout=LayoutRight(E(m, m))), v),
        "matvec_left": ops.matvec(MdSpan.from_dense(a_left, layout=LayoutLeft(E(m, m))), v),
    }
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    tiny = tm.tinymatsum_torch(o, s)
    checks = {
        "sum3d_right": _sum_tolerance(x)(out["sum3d_right"], sm.sum3d_torch(x))[0],
        "sum3d_left": _sum_tolerance(x_left)(out["sum3d_left"], sm.sum3d_torch(x_left))[0],
        "stencil3d": _allclose(1e-4, 1e-4)(out["stencil3d"], st.stencil3d_torch(x))[0],
        "tinymatsum_static": _allclose(1e-6, 1e-6)(out["tinymatsum_static"], tiny)[0],
        "tinymatsum_dynamic": _allclose(1e-6, 1e-6)(out["tinymatsum_dynamic"], tiny)[0],
        "matvec_right": _row_tolerance(a, v)(out["matvec_right"], mv.matvec_torch(a, v))[0],
        "matvec_left": _row_tolerance(a_left, v)(out["matvec_left"],
                                                 mv.matvec_torch(a_left, v))[0],
    }
    finite = {k: bool(torch.isfinite(t).all()) for k, t in out.items()}
    rec = {"phase": "paper_main_path", "sizes": label, "cube": n3, "tiny_n": n, "mat": m,
           "agree_with_plain": checks, "finite": finite,
           "launches": {k: launches[k] for k in PAPER_PATH}, "wall_s": wall}
    emit(rec)
    if not all(checks.values()) or not all(finite.values()):
        raise AssertionError(f"the paper path disagrees with the plain versions: {rec}")
    for k in PAPER_PATH:
        if launches[k] <= 0:
            raise AssertionError(f"the paper path never launched {k}")
    return launches


def paper_phase(bw):
    """The checks at both size sets, the zero-overhead comparison, then the
    main path with its launch counts; returns (records, launches)."""
    g = torch.Generator(device="cuda").manual_seed(13)
    recs = {}
    for label in PAPER_SIZES:
        recs = paper_checks(bw, label, g)  # the HBM size set's records stand
        torch.cuda.empty_cache()
    zero_overhead_check(g)
    launches = paper_main_path(g)
    torch.cuda.empty_cache()
    return recs, launches


# =====================================================================================
# phases: engine_exact and serve
# =====================================================================================
def oracle_greedy(model, params, prompt, n, vocab):
    """Unbatched recompute: the whole context through Model.forward (plain
    attention, no paged cache), argmax of the last row, n times."""
    ctx = list(prompt)
    out = []
    for _ in range(n):
        logits, _ = model.forward(params, torch.tensor([ctx], device=model.device))
        tok = int(torch.argmax(logits[0, -1, :vocab]))
        out.append(tok)
        ctx.append(tok)
    return out


def exact_requests(vocab, seed=0):
    """Six prompts of 31-591 tokens (lengths one short of a page boundary, so
    decode appends pages early); the first two share a 256-token prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=256).tolist()
    prompts = [prefix + rng.integers(0, vocab, size=31).tolist(),
               prefix + rng.integers(0, vocab, size=63).tolist()]
    prompts += [rng.integers(0, vocab, size=n).tolist() for n in (591, 303, 127, 31)]
    return prompts


def condition_attention(cfg, params):
    """Rescale wq/wk/wv/wo in place to std 1/sqrt(true fan-in). The
    reference's init draws a (d, h, k) projection with std 1/sqrt(shape[-2]),
    i.e. 1/sqrt(heads) (wq 1/sqrt(14), wk and wv 1/sqrt(2)) and wo (h, k, d)
    with 1/sqrt(head_dim), so attention scores are huge and attention is
    near-argmax. That is chaotic at depth: f32 rounding differences between
    two correct computations flip attention choices and, by 24 layers, the
    greedy token. With the fan-in the layer really has (d_model for wq/wk/wv,
    Hq * head_dim for wo) the model stays well-conditioned, so tokens can be
    compared at full depth."""
    d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
    for p in params["blocks"][0]:
        a = p["attn"]
        a["wq"].mul_(math.sqrt(hq / d))
        a["wk"].mul_(math.sqrt(hkv / d))
        a["wv"].mul_(math.sqrt(hkv / d))
        a["wo"].mul_(math.sqrt(1.0 / hq))
    return params


def depth_sensitivity(prompt, layers, conditioned=False, device="cuda"):
    """Max |logit difference| between two plain computations of the same
    next-token logits — Model.forward over the prompt, and Model.prefill over
    it right-padded to a page (other matmul shapes) — for random f32 weights
    at full width and ``layers`` depth, with the reference's init or (with
    ``conditioned``) after condition_attention. This bounds how deep a
    token-exact check can go."""
    from repro_torch.models import build_model, get_config
    import dataclasses

    cfg = dataclasses.replace(get_config("qwen2-0.5b"), dtype="float32", n_layers=layers)
    model = build_model(cfg, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    if conditioned:
        condition_attention(cfg, params)
    toks = torch.tensor([prompt], device=device)
    fwd, _ = model.forward(params, toks)
    padded = torch.zeros((1, -(-len(prompt) // 16) * 16), dtype=toks.dtype, device=device)
    padded[0, :len(prompt)] = toks[0]
    pre, _ = model.prefill(params, padded, last_index=len(prompt) - 1)
    a, b = fwd[0, -1, :cfg.vocab], pre[0, 0, :cfg.vocab]
    rec = {"phase": "engine_exact_sensitivity", "n_layers": layers,
           "init": "conditioned" if conditioned else "reference", "prompt_len": len(prompt),
           "max_abs_logit_diff": float((a - b).abs().max()),
           "argmax_equal": int(a.argmax()) == int(b.argmax())}
    emit(rec)
    return rec


def run_engine(model, params, prompts, n_new, config, device):
    """One engine run over ``prompts`` with launch counts zeroed just before
    and read just after: (greedy tokens per request, metrics, launches,
    wall seconds)."""
    from repro_torch import kernels
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import Request, ServeEngine

    eng = ServeEngine(model, params, config, device=device)
    reqs = [Request(i, p, GenerationParams(max_new_tokens=n_new)) for i, p in enumerate(prompts)]
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = kernels.launch_counts()
    return [res[i].generated for i in range(len(prompts))], eng.metrics(), launches, wall


EXACT_MODES = (("monolithic", {}), ("chunked", dict(chunked_prefill=True, chunk_tokens=128)))


def exact_config(pool_pages, kv_dtype="f32", **extra):
    from repro_torch.serving.engine import EngineConfig

    return EngineConfig(num_pages=pool_pages, page_size=16, max_batch=8, max_pages_per_seq=40,
                        kv_dtype=kv_dtype, **extra)


def exact_model(cfg_name, smoke, device, n_layers, conditioned, quantized=False):
    """The f32 model at full width (``n_layers`` deep unless smoke) with
    seeded random weights, rescaled by condition_attention if asked."""
    from repro_torch.models import build_model, get_config
    import dataclasses

    cfg = dataclasses.replace(get_config(cfg_name, smoke=smoke), dtype="float32")
    if not smoke:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, quantized=quantized, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    if conditioned:
        condition_attention(cfg, params)
    return cfg, model, params


def check_exact(rec, got, want, m, launches, need, device):
    emit(rec)
    if got != want:
        bad = [i for i in range(len(want)) if got[i] != want[i]]
        raise AssertionError(f"{rec['phase']} {rec['mode']}: tokens differ for requests {bad}")
    if m["preemptions"] < 1:
        raise AssertionError(f"{rec['phase']} {rec['mode']} never preempted: the pool is too large")
    if device == "cuda":
        for k in need:
            if launches[k] <= 0:
                raise AssertionError(f"{rec['phase']} {rec['mode']} never launched {k}")


def engine_exact_phase(cfg_name="qwen2-0.5b", smoke=False, device="cuda", pool_pages=58,
                       n_new=16, n_layers=2, conditioned=False):
    """Greedy tokens of the serving engine vs the unbatched oracle, at full
    width and ``n_layers`` depth. With the reference's init the check holds
    only at shallow depth (at 24 layers two plain computations already
    disagree, see depth_sensitivity); ``conditioned`` applies
    condition_attention so all 24 layers can be checked."""
    cfg, model, params = exact_model(cfg_name, smoke, device, n_layers, conditioned)
    prompts = exact_requests(cfg.vocab)
    t0 = time.perf_counter()
    want = [oracle_greedy(model, params, p, n_new, cfg.vocab) for p in prompts]
    oracle_s = time.perf_counter() - t0
    runs = {}
    for mode, extra in EXACT_MODES:
        got, m, launches, wall = run_engine(model, params, prompts, n_new,
                                            exact_config(pool_pages, **extra), device)
        rec = {
            "phase": "engine_exact", "mode": mode, "model": cfg.name, "dtype": "float32",
            "n_layers": cfg.n_layers, "init": "conditioned" if conditioned else "reference",
            "d_model": cfg.d_model, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
            "tokens_equal_oracle": got == want, "preemptions": m["preemptions"],
            "pages_shared": m["pages_shared"], "cow_copies": m["cow_copies"],
            "prefill_tokens_skipped": m["prefill_tokens_skipped"],
            "launches": {k: launches[k] for k in DENSE_PATH},
            "wall_s": wall, "oracle_s": oracle_s,
        }
        need = DENSE_PATH if mode == "chunked" else DENSE_PATH[:1]
        check_exact(rec, got, want, m, launches, need, device)
        runs[mode] = rec
    return runs


def _to_cpu(tree):
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_cpu(v) for v in tree]
    return tree.cpu()


def engine_exact_quant_phase(kv_dtype, cfg_name="qwen2-0.5b", smoke=False, device="cuda",
                             pool_pages=58, n_new=16, n_layers=2, conditioned=False):
    """Greedy tokens of the engine with int8 MLP weights over ``kv_dtype``
    pages on ``device`` (kernels) vs the same engine with the same weights on
    the CPU (plain versions), in both prefill modes. The oracle is the CPU
    engine and not Model.forward: quantized pages make the paged path's
    logits differ from a dense recompute by design."""
    from repro_torch.models import build_model

    cfg, model, params = exact_model(cfg_name, smoke, device, n_layers, conditioned,
                                     quantized=True)
    cpu_model = build_model(cfg, quantized=True, device="cpu")
    cpu_params = _to_cpu(params)
    prompts = exact_requests(cfg.vocab)
    runs = {}
    for mode, extra in EXACT_MODES:
        config = exact_config(pool_pages, kv_dtype, **extra)
        got, m, launches, wall = run_engine(model, params, prompts, n_new, config, device)
        t0 = time.perf_counter()
        want, m_cpu, _, _ = run_engine(cpu_model, cpu_params, prompts, n_new, config, "cpu")
        cpu_s = time.perf_counter() - t0
        first_diff = [next((j for j, (a, b) in enumerate(zip(g_i, w_i)) if a != b), None)
                      for g_i, w_i in zip(got, want)]
        rec = {
            "phase": "engine_exact_quant", "mode": mode, "model": cfg.name, "dtype": "float32",
            "weights": "int8", "kv_dtype": kv_dtype, "n_layers": cfg.n_layers,
            "init": "conditioned" if conditioned else "reference", "requests": len(prompts),
            "new_tokens": n_new, "tokens_equal_cpu_engine": got == want,
            "first_differing_token": first_diff, "preemptions": m["preemptions"],
            "preemptions_cpu": m_cpu["preemptions"], "pages_shared": m["pages_shared"],
            "cow_copies": m["cow_copies"], "kv_pool_bytes": m["kv_pool_bytes"],
            "launches": {k: launches[k] for k in QUANT_PATH}, "wall_s": wall, "cpu_s": cpu_s,
        }
        need = QUANT_PATH if mode == "chunked" else ("paged_decode_quant", "quant_matmul")
        check_exact(rec, got, want, m, launches, need, device)
        runs[mode] = rec
    return runs


def serve_requests(vocab, n=16, seed=1):
    """16 prompts of 64-512 tokens; four open with one 128-token system prefix."""
    rng = np.random.default_rng(seed)
    prefix = rng.integers(0, vocab, size=128).tolist()
    out = []
    for i in range(n):
        body = rng.integers(0, vocab, size=int(rng.integers(64, 385))).tolist()
        out.append(prefix + body if i % 4 == 0 else body)
    return out


def serve_setup(cfg_name="qwen2-0.5b", smoke=False, device="cuda", n_new=32, quantized=False,
                kv_dtype="f32"):
    """The serve workload: the model at its config dtype (bfloat16) with
    seeded random weights (int8 MLP weights if ``quantized``), the 16 prompts
    and the engine config (``kv_dtype`` pages), after a warm-up run on an
    engine of its own (allocator, cuBLAS handles)."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

    cfg = get_config(cfg_name, smoke=smoke)
    model = build_model(cfg, quantized=quantized, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(1))
    prompts = serve_requests(cfg.vocab)
    config = EngineConfig.sized_for(max(len(p) for p in prompts) + n_new, page_size=16,
                                    max_batch=8, chunked_prefill=True, chunk_tokens=128,
                                    kv_dtype=kv_dtype)
    w = SimpleNamespace(cfg=cfg, prompts=prompts, config=config, n_new=n_new, device=device,
                        weights="int8" if quantized else cfg.dtype)
    w.requests = lambda ps=prompts: [Request(i, p, GenerationParams(max_new_tokens=n_new))
                                     for i, p in enumerate(ps)]
    w.engine = lambda: ServeEngine(model, params, config, device=device)
    w.engine().run(w.requests(prompts[:2]))
    return w


def serve_phase(cfg_name="qwen2-0.5b", smoke=False, device="cuda", n_new=32, workload=None,
                phase="serve", need=DENSE_PATH):
    """One serving run of the workload on a fresh engine, launch counts zeroed
    just before and read just after; every kernel in ``need`` must launch."""
    from repro_torch import kernels

    w = workload or serve_setup(cfg_name, smoke, device, n_new)
    cfg, prompts, config, n_new = w.cfg, w.prompts, w.config, w.n_new
    eng = w.engine()
    reqs = w.requests()
    kernels.reset_launch_counts()
    eng.run(reqs)
    launches = kernels.launch_counts()
    m = eng.metrics()
    rec = {
        "phase": phase, "model": cfg.name, "dtype": cfg.dtype, "weights": w.weights,
        "kv_dtype": config.kv_dtype, "requests": len(prompts),
        "prompt_tokens": sum(len(p) for p in prompts), "new_tokens": n_new,
        "max_batch": config.max_batch, "chunk_tokens": config.chunk_tokens,
        **{k: m[k] for k in ("tokens_per_s", "step_ms_p50", "step_ms_p95", "chunk_ms_p50",
                             "host_overhead_ms_p50", "ttft_s_p50", "ttft_s_p95",
                             "decode_steps", "wall_s", "kv_pool_bytes",
                             "peak_pages_in_use", "pages_shared", "prefill_tokens_skipped",
                             "preemptions")},
        "launches": {k: launches[k] for k in need},
    }
    emit(rec)
    if m["generated_tokens"] != len(prompts) * n_new or m["failed"]:
        raise AssertionError(f"{phase} phase did not complete every request: {m}")
    for seq in eng.results.values():
        if not all(0 <= t < cfg.vocab for t in seq.generated):
            raise AssertionError("a generated token lies outside the vocabulary")
    if w.device == "cuda":
        for k in need:
            if launches[k] <= 0:
                raise AssertionError(f"the {phase} path never launched {k}")
    return rec


def serve_quant_phase(dense_pool_bytes, cfg_name="qwen2-0.5b", smoke=False, device="cuda",
                      n_new=32):
    """The serve workload with int8 MLP weights over int8, then int4, KV
    pages, one run each; the int8 pool must be >= 1.9x smaller than the
    dense (bf16) pool of the same page count."""
    runs = {}
    for kv in ("int8", "int4"):
        w = serve_setup(cfg_name, smoke, device, n_new, quantized=True, kv_dtype=kv)
        rec = serve_phase(workload=w, phase="serve_quant", need=QUANT_PATH)
        rec["kv_pool_bytes_vs_dense"] = dense_pool_bytes / rec["kv_pool_bytes"]
        emit({"phase": "serve_quant_pool", "kv_dtype": kv, "kv_pool_bytes": rec["kv_pool_bytes"],
              "dense_kv_pool_bytes": dense_pool_bytes,
              "smaller_by": rec["kv_pool_bytes_vs_dense"]})
        runs[kv] = rec
    if runs["int8"]["kv_pool_bytes_vs_dense"] < 1.9:
        raise AssertionError(f"int8 pool only {runs['int8']['kv_pool_bytes_vs_dense']:.3f}x "
                             "smaller than the dense pool")
    return runs


# =====================================================================================
def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script needs one NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        from repro_torch.kernels import _build
    except ImportError as e:
        print(f"chip_smoke: repro_torch not found next to this script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    smi = nvidia_smi_line()
    t0 = time.perf_counter()
    _build.build_all()
    build_s = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in _build.build_log(name).splitlines()
                    if "registers" in ln or "spill" in ln] for name in _build.SOURCES}
    bw = copy_bandwidth()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build_s, "built": sorted(_build.build_seconds),
          "copy_bw_bytes_per_s": bw, "nominal_bw_bytes_per_s": NOMINAL_BW,
          "ptxas": ptxas})
    t_phase = {}
    t0 = time.perf_counter()
    main_recs = kernel_phase(bw)
    t_phase["kernels"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    paper_recs, paper_launches = paper_phase(bw)
    main_recs.update(paper_recs)
    t_phase["paper"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    prompt = exact_requests(151936)[0]
    for layers, conditioned in ((2, False), (24, False), (24, True)):
        depth_sensitivity(prompt, layers, conditioned)
    engine_exact_phase(n_layers=2)
    engine_exact_phase(n_layers=24, conditioned=True)
    t_phase["engine_exact"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for kv in ("int8", "int4"):
        engine_exact_quant_phase(kv, n_layers=2)
    engine_exact_quant_phase("int8", n_layers=24, conditioned=True, n_new=8)
    t_phase["engine_exact_quant"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    workload = serve_setup()
    runs = [serve_phase(workload=workload) for _ in range(SERVE_RUNS)]
    serve = runs[0]
    emit({"phase": "serve_summary", "runs": SERVE_RUNS,
          **{k: [r[k] for r in runs] for k in ("tokens_per_s", "step_ms_p50", "chunk_ms_p50",
                                                "ttft_s_p95")},
          "step_ms_p50_median": statistics.median(r["step_ms_p50"] for r in runs)})
    t_phase["serve"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    serve_quant = serve_quant_phase(serve["kv_pool_bytes"])
    t_phase["serve_quant"] = time.perf_counter() - t0
    launches = {**serve["launches"], **serve_quant["int8"]["launches"],
                **{k: paper_launches[k] for k in PAPER_PATH}}
    kernels = []
    for name, (replaces, source) in PORTED.items():
        rec = main_recs[name]
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    emit({"kernels": kernels,
          "not_ported": [{"name": n, "replaces": r} for n, r in NOT_PORTED],
          "phase_seconds": t_phase, "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
