#!/usr/bin/env python3
"""Time the SSD scan (ssd_scan, Mamba-2's chunked scan) of one checkout on one
GPU, and mamba2-780m's bf16 prefill around it, so that two trees can be
compared in one call.

    python3 scripts/time_ssd_scan.py [--tree DIR] [--label NAME]
                                     [--prefill-runs N] [--variants] [--phases]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` and its ``chip_smoke.py`` are imported, and its kernels are
built into DIR/build. Only public entry points are called (``ssd_scan``,
``ssd_torch``, ``make_prefill``), so any two trees of the port time the same
calls. Prints one JSON line per measurement, each with NAME and the card's
name and power limit (``nvidia-smi --query-gpu=name,power.limit
--format=csv,noheader``):

  copy      the device-to-device copy rate of a 1 GiB buffer (bytes read +
            written per second), for reference only;
  ssd_scan  the kernel at mamba2-780m's width (h 48, p 64, n 128) at B 2 and
            4 and T 512 and 389, f32 and bf16, inputs as chip_smoke.py draws
            them: whether it agrees with the plain version (chip_smoke.py's
            gate), CUDA-event ms a call (median of 30, host wrapper
            included), device ms a call (50 calls queued behind a sleep
            kernel), the bytes bound (each input read once, each output
            written once, over the data sheet's HBM3 rate), the operations bound
            (chip_smoke.py's ssd_flops over the dtype's peak: 989e12 bf16 on
            the tensor cores, 67e12 f32 on the FMA pipes) and which is larger;
  prefill   mamba2-780m at full size (48 layers, random weights from seed
            0), bf16, B 4 x 512, ``make_prefill(max_len=544)`` on the
            kernels: N timed runs after two warm-ups, each a host clock
            around one prefill ending in a synchronize, their median, and
            the ssd_scan launches of one prefill.

With --variants (this tree's csrc/ssd_scan.cu), the scan is also built with
other constants (the source copied with its kPS and kWarps lines edited,
built with nvcc and kernels/_build.FLAGS into DIR/build/variants) and called
through ctypes with the wrapper's signature: P slices of 16, 32 and 64
columns and 8 or 16 warps a block, each checked against the plain version
and timed (device ms) at B 2 and 4 x 512, f32 and bf16, beside its resident
blocks an SM and ptxas's registers and spills.

With --phases (this tree's csrc/ssd_scan.cu), where the scan's time goes:
the source is copied with one phase cut out at a time (a textual edit at an
anchor of the source, each asserted to be there; the results are wrong and
only timed), built like the variants and timed (device ms) at B 2 and 4 x
512: no_stage (each block stages its first chunk only), no_cb (the C . B
kernel not launched), cb_only (only the C . B kernel), no_m (f32: the M
pass), no_y (the y warps idle), no_update (the update warps idle) and
no_products (both). A phase's cost is the full kernel's device ms
less the cut one's.

Compare two trees in turns (A, B, B, A) within one call. Needs one GPU and
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BW = 3.35e12  # H100 SXM HBM3, bytes a second (data sheet): the bytes bounds' rate

SHAPES = [(2, 512), (4, 512), (2, 389), (4, 389)]
WIDTH = (48, 64, 128)  # mamba2-780m: heads, head dim, state
VARIANTS = [(32, 8), (16, 8), (64, 8), (32, 16)]  # (P slice, warps); the first is the built one


def ssd_inputs(g, b, t, dtype):
    """chip_smoke.py's draw: x, B, C in dtype, dt softplus, A negative."""
    h, p, n = WIDTH
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(dtype)
    x = rnd(b, t, h, p)
    dt = torch.nn.functional.softplus(torch.randn(b, t, h, generator=g, device="cuda"))
    A = -torch.exp(0.3 * torch.randn(h, generator=g, device="cuda"))
    return x, dt, A, rnd(b, t, 1, n) * 0.3, rnd(b, t, 1, n) * 0.3


def bounds(smoke, b, t, dtype, bw):
    h, p, n = WIDTH
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = (2 * b * t * h * p + 2 * b * t * n) * esz + b * t * h * 4 + h * 4 + b * h * p * n * 4
    flops = smoke.ssd_flops(b, t, h, p, n)
    t_bytes, t_ops = nbytes / bw * 1e3, flops / smoke.PEAK_FLOPS[dtype] * 1e3
    return {"bytes": nbytes, "flops": flops, "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
            "bound_ms": max(t_bytes, t_ops), "bound_by": "bytes" if t_bytes >= t_ops else
            "operations"}


def agrees(smoke, got, want, dtype):
    flat = lambda y, s: torch.cat([y.float().flatten(), s.flatten()])
    ok, _ = smoke._scan_tolerance(got[0].numel(), dtype)(flat(*got), flat(*want))
    return ok


def time_scans(smoke, ss, g, bw, emit):
    for b, t in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            x, dt, A, Bm, Cm = ssd_inputs(g, b, t, dtype)
            kernel = lambda: ss.ssd_scan(x, dt, A, Bm, Cm, return_final_state=True)
            want = ss.ssd_torch(x, dt, A, Bm, Cm, chunk=t if t % 64 else 128,
                                return_final_state=True)
            emit({"kernel": "ssd_scan", "b": b, "t": t, "h": WIDTH[0], "p": WIDTH[1],
                  "n": WIDTH[2], "dtype": str(dtype).split(".")[1],
                  "agrees_with_plain": agrees(smoke, kernel(), want, dtype),
                  "ms": smoke.time_ms(kernel), "device_ms": smoke.device_ms_per_call(kernel, n=50),
                  **bounds(smoke, b, t, dtype, bw)})


def time_prefill(smoke, runs, emit):
    from repro_torch import kernels
    from repro_torch.serving import make_prefill

    cfg, model, params = smoke.generate_model("mamba2-780m", "bfloat16")
    b, s = smoke.GEN_CELLS["mamba2-780m"]["batch"], 512
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(3)).cuda()
    prefill = make_prefill(model, max_len=s + 32, attn_impl="auto")
    for _ in range(2):
        prefill(params, prompts)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prefill(params, prompts)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["ssd_scan"]
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        prefill(params, prompts)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    emit({"prefill": cfg.name, "dtype": "bfloat16", "n_layers": cfg.n_layers, "batch": b,
          "prompt_len": s, "prefill_ms": times, "prefill_ms_median": statistics.median(times),
          "ssd_scan_launches": launches})


def build_cut(tree, name, edits):
    """The tree's csrc/ssd_scan.cu with ``edits`` ((anchor, replacement),
    each anchor asserted to be there once) built into DIR/build/variants;
    returns the library's path and what nvcc printed."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / _build.SOURCES["ssd_scan"]).read_text()
    for anchor, new in edits:
        assert src.count(anchor) == 1, f"{name}: anchor not found once: {anchor!r}"
        src = src.replace(anchor, new)
    out = tree / "build" / "variants" / f"ssd_scan_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cut = out.with_suffix(".cu")
    cut.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, f"-I{_build.CSRC}", "-o", str(out),
                           str(cut)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return out, proc.stdout + proc.stderr


# phase -> [(anchor in csrc/ssd_scan.cu, replacement)]: the cut copies of --phases
_STAGE = [("    const size_t tok = static_cast<size_t>(b) * p.t_len + c0;\n",
           "    const size_t tok = static_cast<size_t>(b) * p.t_len + c0;\n    if (c == 0) {\n"),
          ("    cp_async_wait<0>();\n    __syncthreads();\n\n    if constexpr (kBf16<T>) {",
           "    cp_async_wait<0>();\n    }\n    __syncthreads();\n\n    if constexpr (kBf16<T>) {")]
_Y = [("      if (y_warp) {\n        // y = exp(s) (C . S^T) + M . x, M",  # bf16
       "      if (false) {\n        // y = exp(s) (C . S^T) + M . x, M"),
      ("      if (y_warp) {\n        if (warp == 0) {",  # f32
       "      if (false) {\n        if (warp == 0) {")]
_BF16_U, _F32_U = "        // S <- exp(s_Q) S + (w o x)^T . B, w_u", "        // S <- exp(s_Q) S + (w o x)^T . B: tiles"
_ELSE_NOT_Y = [(f"      }} else {{\n{c}", f"      }} else if (!y_warp) {{\n{c}") for c in (_BF16_U, _F32_U)]
# the update's products only
_U = [(f"      }} else {{\n{_BF16_U}", f"      }} else if (false) {{\n{_BF16_U}"),
      ("      if (!y_warp) split_state();\n", ""),
      ("        for (int u2 = 0; u2 < kQ / 2; ++u2) {", "        for (int u2 = 0; u2 < 0; ++u2) {"),
      ("      if (!y_warp) {\n        const int ut", "      if (false) {\n        const int ut")]
PHASES = {
    "no_stage": _STAGE,
    "no_cb": [("    cb_kernel<T><<<", "    if (false) cb_kernel<T><<<")],
    "cb_only": [("  kern<<<dim3(", "  if (false) kern<<<dim3(")],
    "no_m": [("            *mp = u <= t ?", "            if (false) *mp = u <= t ?")],
    "no_y": _Y + _ELSE_NOT_Y,
    "no_update": _U,
    "no_products": _Y + _U + _ELSE_NOT_Y[1:],
}


def bind(path, ss):
    lib = ctypes.CDLL(str(path))
    fn = lib.repro_ssd_scan
    fn.argtypes, fn.restype = ss._LIB.signatures["repro_ssd_scan"], ctypes.c_int
    return lib, fn


def raw_call(fn, what, code, b, t, x, dt, A, Bm, Cm):
    """A call of a built library's repro_ssd_scan with the wrapper's
    arguments (its own outputs and C . B workspace)."""
    h, p, n = WIDTH
    y = torch.empty_like(x)
    st = torch.empty(b, h, p, n, device="cuda")
    cb = torch.empty(b, -(-t // 64), 64, 64, device="cuda")

    def call():
        err = fn(code, x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(), Cm.data_ptr(),
                 None, y.data_ptr(), st.data_ptr(), cb.data_ptr(), b, t, h, p, n,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{what} launch failed: CUDA error {err}")
        return y, st
    return call


def time_phases(tree, smoke, ss, g, emit):
    from repro_torch.kernels import _build

    full = {}
    for phase in ["full", *PHASES]:
        path = (_build.library_path("ssd_scan") if phase == "full"
                else build_cut(tree, phase, PHASES[phase])[0])
        _, fn = bind(path, ss)
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            if dtype == torch.bfloat16 and phase == "no_m":
                continue  # the f32 pass
            for b, t in SHAPES[:2]:
                call = raw_call(fn, phase, code, b, t, *ssd_inputs(g, b, t, dtype))
                ms = smoke.device_ms_per_call(call, n=50)
                key = (str(dtype).split(".")[1], b)
                full.setdefault(key, ms)
                emit({"phase_cut": phase, "dtype": key[0], "b": b, "t": t, "device_ms": ms,
                      "phase_ms": full[key] - ms if phase != "full" else None})


def time_variants(tree, smoke, ss, g, emit):
    import re

    for ps, warps in VARIANTS:
        path, log = build_cut(tree, f"ps{ps}_w{warps}", [
            ("constexpr int kPS = 32;", f"constexpr int kPS = {ps};"),
            ("constexpr int kWarps = 8;", f"constexpr int kWarps = {warps};")])
        lib, fn = bind(path, ss)
        occ = lib.repro_ssd_blocks_per_sm
        occ.argtypes, occ.restype = ss._LIB.signatures["repro_ssd_blocks_per_sm"], ctypes.c_int
        regs = [int(r) for r in re.findall(r"Used (\d+) registers", log)]
        spills = [int(s) for s in re.findall(r"(\d+) bytes spill stores", log)]
        for dtype, code in ((torch.float32, 0), (torch.bfloat16, 1)):
            blocks = ctypes.c_int(0)
            rc = occ(code, WIDTH[2], ctypes.byref(blocks))
            for b, t in SHAPES[:2]:
                x, dt, A, Bm, Cm = ssd_inputs(g, b, t, dtype)
                h, p, n = WIDTH
                call = raw_call(fn, f"variant ({ps}, {warps})", code, b, t, x, dt, A, Bm, Cm)
                ok = agrees(smoke, call(), ss.ssd_torch(x, dt, A, Bm, Cm, chunk=128,
                                                        return_final_state=True), dtype)
                emit({"variant": {"p_slice": ps, "warps": warps}, "b": b, "t": t,
                      "dtype": str(dtype).split(".")[1], "agrees_with_plain": ok,
                      "device_ms": smoke.device_ms_per_call(call, n=50),
                      "blocks": b * h * -(-p // ps), "resident_blocks_per_sm":
                      blocks.value if rc == 0 else None, "ptxas_registers": regs,
                      "ptxas_spill_stores": spills})


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--prefill-runs", type=int, default=5)
    ap.add_argument("--variants", action="store_true")
    ap.add_argument("--phases", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_ssd_scan: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    smoke = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build
    from repro_torch.kernels import ssd_scan as ss

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.load("ssd_scan")
    card = smoke.nvidia_smi_line()
    base = {"label": args.label, "tree": str(tree), "card": card}
    emit = lambda rec: print(json.dumps({**base, **rec}), flush=True)
    bw = HBM_BW  # a copy reads and writes: a read-mostly kernel can pass its rate
    emit({"copy_bytes_per_s": smoke.copy_bandwidth(), "bound_bytes_per_s": bw})
    g = torch.Generator(device="cuda").manual_seed(0)
    time_scans(smoke, ss, g, bw, emit)
    torch.cuda.empty_cache()
    if args.prefill_runs:
        time_prefill(smoke, args.prefill_runs, emit)
        torch.cuda.empty_cache()
    if args.variants:
        time_variants(tree, smoke, ss, g, emit)
    if args.phases:
        time_phases(tree, smoke, ss, g, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
