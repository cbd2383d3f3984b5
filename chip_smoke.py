#!/usr/bin/env python3
"""End-to-end proof that the PyTorch/CUDA port (src/repro_torch) serves on one
NVIDIA GPU, on its own hand-written kernels.

    python3 chip_smoke.py

Builds the CUDA kernels from the checkout's sources (nvcc, into build/), then
runs five phases, each printing one JSON line; any failure raises and exits
non-zero:

  device        GPU name and power limit, torch/CUDA versions, kernel build
                time, and the device-to-device copy bandwidth the bounds use.
  kernels       each kernel against its plain PyTorch version at the serving
                path's shapes (Hq 14, Hkv 2, D 64, page 16, B 8, and the serve
                phase's one-row 128-token chunk), in f32
                (tolerance 2e-5) and over bf16 pools (within one bf16 ulp of
                the plain output plus the f32 tolerance 2e-5, for outputs near
                0 whose bf16 spacing is finer than f32 sums resolve): error,
                kernel ms, plain ms, bound ms, and scaled_dot_product_attention over the densified cache as a
                yardstick (timed here only; the port never calls it).
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
  serve         the same model in bf16, chunked prefill, prefix sharing,
                max_batch 8, 16 requests, three runs on fresh engines:
                tokens/s, step and chunk times, TTFT, then a serve_summary
                line. Launch counts are zeroed just before and read just
                after each run (the serving path), and both must be > 0; the
                kernels line reports the first run's.
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
REPLACES = {
    "paged_decode": "src/repro/kernels/paged_attention.py:151",
    "paged_prefill_chunk": "src/repro/kernels/paged_attention.py:575",
}
SOURCE = "src/repro_torch/kernels/csrc/paged_attention.cu"
NOT_PORTED = [
    ("paged_flash_decode_quant", "src/repro/kernels/paged_attention.py:387"),
    ("paged_flash_prefill_chunk_quant", "src/repro/kernels/paged_attention.py:756"),
    ("quant_matmul", "src/repro/kernels/quant_matmul.py:57"),
    ("flash_attention", "src/repro/kernels/flash_attention.py:104"),
    ("flash_decode", "src/repro/kernels/flash_attention.py:222"),
    ("ssd_scan", "src/repro/kernels/ssd_scan.py:85"),
    ("rglru_scan", "src/repro/kernels/rglru_scan.py:50"),
    ("matvec_right/matvec_left", "src/repro/kernels/matvec.py:33"),
    ("sum3d_pallas", "src/repro/kernels/sum3d.py:37"),
    ("stencil3d_pallas", "src/repro/kernels/stencil3d.py:59"),
    ("tinymatsum_static/dynamic", "src/repro/kernels/tinymatsum.py:34"),
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


def check_and_time(name, dtype, kernel, plain, library, nbytes, flops, bw, case):
    got = kernel()
    torch.cuda.synchronize()
    want = plain()
    err = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
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
        "phase": "kernels", "kernel": name, "dtype": str(dtype).split(".")[1], **case,
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
    from repro_torch.kernels import paged_attention as pa

    g = torch.Generator(device="cuda").manual_seed(0)
    B, HQ, HKV, D, PS, MAXP = 8, 14, 2, 64, 16, 128
    NUM = B * MAXP + 1
    lens = [0, 1, 16, 100, 517, 1024, 1500, 2048]  # a length-0 row, exactly one page
    main = {}
    for dtype in (torch.float32, torch.bfloat16):
        esz = torch.tensor([], dtype=dtype).element_size()
        rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
        kp, vp = rnd(NUM, HKV, PS, D), rnd(NUM, HKV, PS, D)
        perm = torch.randperm(NUM - 1, generator=g, device="cuda") + 1
        bt = perm.reshape(B, MAXP).to(torch.int32).contiguous()
        kd, vd = densify(kp, bt), densify(vp, bt)
        # decode
        q = rnd(B, HQ, 1, D)
        cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
        live = torch.arange(MAXP * PS, device="cuda")[None, :] < cl[:, None]
        mask = live[:, None, None, :]
        tokens = sum(lens)
        nbytes = (2 * q.numel() * esz + 2 * tokens * HKV * D * esz + bt.numel() * 4 + B * 4)
        rec = check_and_time(
            "paged_decode", dtype,
            lambda: pa.paged_flash_decode(q, kp, vp, bt, cl),
            lambda: pa.paged_decode_attention_torch(q, kp, vp, bt, cl),
            lambda: sdpa(q, kd, vd, mask),
            nbytes, 4 * tokens * HQ * D, bw,
            {"B": B, "Hq": HQ, "Hkv": HKV, "D": D, "page_size": PS, "lens": lens},
        )
        if dtype == torch.bfloat16:
            main["paged_decode"] = rec
        # chunked prefill: C in {16, 256, 5} at B 8 with cursors 0 and > 0, and
        # the serve phase's own shape (one row, a 128-token chunk)
        for c, cursors in ((16, [0, 16, 64, 256, 512, 1024, 1536, 1792]),
                           (256, [0, 0, 128, 256, 512, 1024, 1280, 1792]),
                           (5, [0, 3, 17, 100, 517, 1024, 1500, 2000]),
                           (128, [256])):
            nb = len(cursors)
            btc = bt[:nb].contiguous()
            qc, ck, cv = rnd(nb, HQ, c, D), rnd(nb, HKV, c, D), rnd(nb, HKV, c, D)
            cur = torch.tensor(cursors, dtype=torch.int32, device="cuda")
            s = MAXP * PS
            past = torch.arange(s, device="cuda")[None, None, :] < cur[:, None, None]
            tq = torch.arange(c, device="cuda")
            present = (tq[None, :] <= tq[:, None])[None].expand(nb, c, c)
            cmask = torch.cat([past.expand(nb, c, s), present], dim=-1)[:, None]
            kk, vv = torch.cat([kd[:nb], ck], dim=2), torch.cat([vd[:nb], cv], dim=2)
            keys = sum(cur_b * c + c * (c + 1) // 2 for cur_b in cursors)
            nbytes = ((2 * qc.numel() + ck.numel() + cv.numel()) * esz
                      + 2 * sum(cursors) * HKV * D * esz + btc.numel() * 4 + nb * 4)
            rec = check_and_time(
                "paged_prefill_chunk", dtype,
                lambda: pa.paged_flash_prefill_chunk(qc, ck, cv, kp, vp, btc, cur),
                lambda: pa.paged_prefill_chunk_torch(qc, ck, cv, kp, vp, btc, cur),
                lambda: sdpa(qc, kk, vv, cmask),
                nbytes, 4 * keys * HQ * D, bw,
                {"B": nb, "Hq": HQ, "Hkv": HKV, "D": D, "page_size": PS, "C": c,
                 "cursors": cursors},
            )
            if dtype == torch.bfloat16 and c == 128:
                main["paged_prefill_chunk"] = rec
    torch.cuda.synchronize()
    return main


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


def engine_exact_phase(cfg_name="qwen2-0.5b", smoke=False, device="cuda", pool_pages=58,
                       n_new=16, n_layers=2, conditioned=False):
    """Greedy tokens of the serving engine vs the unbatched oracle, at full
    width and ``n_layers`` depth. With the reference's init the check holds
    only at shallow depth (at 24 layers two plain computations already
    disagree, see depth_sensitivity); ``conditioned`` applies
    condition_attention so all 24 layers can be checked."""
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine
    import dataclasses

    cfg = dataclasses.replace(get_config(cfg_name, smoke=smoke), dtype="float32")
    if not smoke:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    model = build_model(cfg, device=device)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen)
    if conditioned:
        condition_attention(cfg, params)
    prompts = exact_requests(cfg.vocab)
    t0 = time.perf_counter()
    want = [oracle_greedy(model, params, p, n_new, cfg.vocab) for p in prompts]
    oracle_s = time.perf_counter() - t0
    pa.reset_launch_counts()
    runs = {}
    for mode, extra in (("monolithic", {}), ("chunked", dict(chunked_prefill=True,
                                                                 chunk_tokens=128))):
        before = pa.launch_counts()
        eng = ServeEngine(model, params, EngineConfig(
            num_pages=pool_pages, page_size=16, max_batch=8, max_pages_per_seq=40, **extra,
        ), device=device)
        t0 = time.perf_counter()
        res = eng.run([Request(i, p, GenerationParams(max_new_tokens=n_new))
                       for i, p in enumerate(prompts)])
        wall = time.perf_counter() - t0
        m = eng.metrics()
        after = pa.launch_counts()
        launches = {k: after[k] - before[k] for k in after}
        got = [res[i].generated for i in range(len(prompts))]
        rec = {
            "phase": "engine_exact", "mode": mode, "model": cfg.name, "dtype": "float32",
            "n_layers": cfg.n_layers, "init": "conditioned" if conditioned else "reference",
            "d_model": cfg.d_model, "requests": len(prompts),
            "prompt_lens": [len(p) for p in prompts], "new_tokens": n_new,
            "tokens_equal_oracle": got == want, "preemptions": m["preemptions"],
            "pages_shared": m["pages_shared"], "cow_copies": m["cow_copies"],
            "prefill_tokens_skipped": m["prefill_tokens_skipped"], "launches": launches,
            "wall_s": wall, "oracle_s": oracle_s,
        }
        emit(rec)
        if got != want:
            bad = [i for i in range(len(prompts)) if got[i] != want[i]]
            raise AssertionError(f"{mode} engine tokens differ from the oracle for requests {bad}")
        if m["preemptions"] < 1:
            raise AssertionError(f"{mode} engine never preempted: the pool is too large")
        if device == "cuda":
            need = ["paged_decode"] + (["paged_prefill_chunk"] if mode == "chunked" else [])
            for k in need:
                if launches[k] <= 0:
                    raise AssertionError(f"{mode} engine never launched {k}")
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


def serve_setup(cfg_name="qwen2-0.5b", smoke=False, device="cuda", n_new=32):
    """The serve workload: the model at its config dtype (bfloat16) with
    seeded random weights, the 16 prompts and the engine config, after a
    warm-up run on an engine of its own (allocator, cuBLAS handles)."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

    cfg = get_config(cfg_name, smoke=smoke)
    model = build_model(cfg, device=device)
    params = model.init_params(torch.Generator(device=device).manual_seed(1))
    prompts = serve_requests(cfg.vocab)
    config = EngineConfig.sized_for(max(len(p) for p in prompts) + n_new, page_size=16,
                                    max_batch=8, chunked_prefill=True, chunk_tokens=128)
    w = SimpleNamespace(cfg=cfg, prompts=prompts, config=config, n_new=n_new, device=device)
    w.requests = lambda ps=prompts: [Request(i, p, GenerationParams(max_new_tokens=n_new))
                                     for i, p in enumerate(ps)]
    w.engine = lambda: ServeEngine(model, params, config, device=device)
    w.engine().run(w.requests(prompts[:2]))
    return w


def serve_phase(cfg_name="qwen2-0.5b", smoke=False, device="cuda", n_new=32, workload=None):
    """One serving run of the workload on a fresh engine, launch counts zeroed
    just before and read just after."""
    from repro_torch.kernels import paged_attention as pa

    w = workload or serve_setup(cfg_name, smoke, device, n_new)
    cfg, prompts, config, n_new = w.cfg, w.prompts, w.config, w.n_new
    eng = w.engine()
    reqs = w.requests()
    pa.reset_launch_counts()
    eng.run(reqs)
    launches = pa.launch_counts()
    m = eng.metrics()
    rec = {
        "phase": "serve", "model": cfg.name, "dtype": cfg.dtype, "requests": len(prompts),
        "prompt_tokens": sum(len(p) for p in prompts), "new_tokens": n_new,
        "max_batch": config.max_batch, "chunk_tokens": config.chunk_tokens,
        **{k: m[k] for k in ("tokens_per_s", "step_ms_p50", "step_ms_p95", "chunk_ms_p50",
                             "host_overhead_ms_p50", "ttft_s_p50", "ttft_s_p95",
                             "decode_steps", "wall_s",
                             "peak_pages_in_use", "pages_shared", "prefill_tokens_skipped",
                             "preemptions")},
        "launches": launches,
    }
    emit(rec)
    if m["generated_tokens"] != len(prompts) * n_new or m["failed"]:
        raise AssertionError(f"serve phase did not complete every request: {m}")
    for seq in eng.results.values():
        if not all(0 <= t < cfg.vocab for t in seq.generated):
            raise AssertionError("a generated token lies outside the vocabulary")
    if w.device == "cuda":
        for k, n in launches.items():
            if n <= 0:
                raise AssertionError(f"the serving path never launched {k}")
    return rec


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
    ptxas = [ln.strip() for ln in _build.build_log("paged_attention").splitlines()
             if "registers" in ln or "spill" in ln]
    bw = copy_bandwidth()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "kind": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0],
          "build_s": build_s, "built": sorted(_build.build_seconds),
          "copy_bw_bytes_per_s": bw, "nominal_bw_bytes_per_s": NOMINAL_BW,
          "ptxas": ptxas})
    main_recs = kernel_phase(bw)
    prompt = exact_requests(151936)[0]
    for layers, conditioned in ((2, False), (24, False), (24, True)):
        depth_sensitivity(prompt, layers, conditioned)
    engine_exact_phase(n_layers=2)
    engine_exact_phase(n_layers=24, conditioned=True)
    workload = serve_setup()
    runs = [serve_phase(workload=workload) for _ in range(SERVE_RUNS)]
    serve = runs[0]
    emit({"phase": "serve_summary", "runs": SERVE_RUNS,
          **{k: [r[k] for r in runs] for k in ("tokens_per_s", "step_ms_p50", "chunk_ms_p50",
                                                "ttft_s_p95")},
          "step_ms_p50_median": statistics.median(r["step_ms_p50"] for r in runs)})
    kernels = []
    for name, rec in main_recs.items():
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": serve["launches"][name], "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "plain_ms": rec["plain_ms"], "bound_ms": rec["bound_ms"],
            "bound_by": rec["bound_by"], "library_ms": rec["library_ms"],
        })
    emit({"kernels": kernels,
          "not_ported": [{"name": n, "replaces": r} for n, r in NOT_PORTED],
          "seconds": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
