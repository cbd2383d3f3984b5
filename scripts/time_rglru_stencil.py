#!/usr/bin/env python3
"""Time the RG-LRU scan (rglru_scan) and the paper's Stencil3D (stencil3d) of
one checkout on one GPU, and recurrentgemma-2b's bf16 prefill around the
scan, so that two trees can be compared in one call.

    python3 scripts/time_rglru_stencil.py [--tree DIR] [--label NAME]
                                          [--prefill-runs N] [--variants]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` and its ``chip_smoke.py`` are imported, and its kernels are
built into DIR/build. Only public entry points are called (``rglru_scan``,
``rglru_torch``, ``stencil3d``, ``stencil3d_torch``, ``make_prefill``), so
any two trees of the port time the same calls. Prints one JSON line per
measurement, each with NAME and the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``):

  copy       the device-to-device copy rate of a 1 GiB buffer (bytes read +
             written per second), for reference only;
  rglru_scan the kernel at recurrentgemma-2b's width, (2, 2600, 2560) and
             (2, 2040, 2560), f32 and bf16, without an initial state, inputs
             as chip_smoke.py draws them: whether it agrees with the plain
             version (chip_smoke.py's gate), CUDA-event ms a call (median of
             30, the host wrapper included), device ms a call (50 calls
             queued behind a sleep kernel) and the bytes bound (read a and b,
             write y and the f32 final state, over the data sheet's HBM3 rate);
  stencil3d  the kernel at 96^3 and 512^3, f32 and bf16, on chip_smoke.py's
             mean-1 inputs: whether it equals the plain version bit for bit,
             event and device ms, and the bytes bound (read x, write out);
             the operations bound (26 f32 additions an interior output over
             67e12 / s) is far below it;
  prefill    recurrentgemma-2b at full size (26 layers, random weights from
             seed 0), bf16, B 2 x 2600, ``make_prefill(max_len=2632)`` on
             the kernels: N timed runs after two warm-ups, each a host clock
             around one prefill ending in a synchronize, their median, and
             the rglru_scan launches of one prefill.

With --variants (this tree's sources), the two kernels are also built with
other constants (the source copied with its constant lines edited, built
with nvcc and kernels/_build.FLAGS into DIR/build/variants, all at once) and
called through ctypes with the wrappers' arguments, each checked against
the plain version and timed (device ms), beside ptxas's registers and
spills (and, for the stencil, the occupancy query's resident blocks an SM):
rglru_scan with rings of 1, 2, 4 and 8 stages at 32 columns a block and
with 16 and 64 columns at 4 stages, at (2, 2600, 2560) and (2, 2040, 2560),
f32 and bf16 (one block a work item); stencil3d: the built kernel (8 j x 64
k tiles, 4 j-rows a thread, a 4-plane ring) at 96^3 with runs of 1, 2, 3,
4, 8 and 32 planes and at 512^3 with runs of 8, 16 and 32, and, at 512^3
and runs of 32, with its 27 additions cut (each output one staged value:
the bytes path alone), tiles of 16 x 32 (2 and 4 rows a thread), 16 x 64
and 8 x 128, 2 rows a thread, and rings of 2 and 8 planes.

Compare two trees in turns (A, B, B, A) within one call. Needs one GPU and
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import itertools
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import torch

HBM_BW = 3.35e12  # H100 SXM HBM3, bytes a second (data sheet): the bytes bounds' rate

RGLRU_SHAPES = [(2, 2600, 2560), (2, 2040, 2560)]  # recurrentgemma-2b's prompts, B 2
CUBES = [96, 512]  # the paper's Stencil3D sizes (the reference's, and HBM-filling)
F32_PEAK = 67e12  # f32 operations a second outside the tensor cores (the stencil's adds)
RGLRU_VARIANTS = [(32, 1), (32, 2), (32, 4), (32, 8), (16, 4), (64, 4)]  # (columns, stages)
# (tile j-rows, tile k, j-rows a thread, ring planes, cut); the first is the
# built one; cut "adds": each output takes one staged value instead of its 27
# additions (wrong, only timed: the bytes path alone)
STENCIL_VARIANTS = [(8, 64, 4, 4, None), (8, 64, 4, 4, "adds"), (16, 32, 2, 4, None),
                    (16, 32, 4, 4, None), (16, 64, 4, 4, None), (8, 128, 4, 4, None),
                    (8, 64, 2, 4, None), (8, 64, 4, 2, None), (8, 64, 4, 8, None)]
STENCIL_RUNS = {96: [1, 2, 3, 4, 8, 32], 512: [8, 16, 32]}  # the built kernel's sweep
_ADDS = ("        for (int q = 0; q < kStRows; ++q) acc[q] += cur[q + dj][dk];\n",
         "        for (int q = 0; q < kStRows; ++q) acc[q] += cur[q + dj][dk];\n"
         "    for (int q = 0; q < kStRows; ++q) acc[q] = cur[q + 1][1];\n")


def dt_name(dtype):
    return str(dtype).split(".")[1]


def rglru_inputs(g, b, t, w, dtype):
    """chip_smoke.py's draw: a in [0.5, 1), b = sqrt(1 - a^2) x."""
    a = torch.rand(b, t, w, generator=g, device="cuda").mul_(0.5).add_(0.5).to(dtype)
    x = torch.randn(b, t, w, generator=g, device="cuda")
    return a, (torch.sqrt(1 - a.float() ** 2) * x).to(dtype)


def rglru_agrees(smoke, got, want, dtype):
    flat = lambda y, h: torch.cat([y.float().flatten(), h.flatten()])
    ok, _ = smoke._scan_tolerance(got[0].numel(), dtype, 1e-5)(flat(*got), flat(*want))
    return ok


def rglru_bound(b, t, w, dtype, bw):
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes = 3 * b * t * w * esz + b * w * 4
    return {"bytes": nbytes, "bound_ms": nbytes / bw * 1e3, "bound_by": "bytes"}


def stencil_bound(n, dtype, bw):
    esz = torch.tensor([], dtype=dtype).element_size()
    nbytes, ops = 2 * n ** 3 * esz, 26 * (n - 2) ** 3
    t_bytes, t_ops = nbytes / bw * 1e3, ops / F32_PEAK * 1e3
    return {"bytes": nbytes, "flops": ops, "bound_ms": max(t_bytes, t_ops),
            "bound_ops_ms": t_ops, "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def time_rglru(smoke, rs, g, bw, emit):
    for b, t, w in RGLRU_SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            a, bt = rglru_inputs(g, b, t, w, dtype)
            kernel = lambda: rs.rglru_scan(a, bt, return_final_state=True)
            want = rs.rglru_torch(a, bt, return_final_state=True)
            emit({"kernel": "rglru_scan", "b": b, "t": t, "w": w, "dtype": dt_name(dtype),
                  "agrees_with_plain": rglru_agrees(smoke, kernel(), want, dtype),
                  "ms": smoke.time_ms(kernel), "device_ms": smoke.device_ms_per_call(kernel, n=50),
                  **rglru_bound(b, t, w, dtype, bw)})
            del a, bt, want


def time_stencil(smoke, st, g, bw, emit):
    for n in CUBES:
        for dtype in (torch.float32, torch.bfloat16):
            x = smoke._sum_input(g, n, n, n, dtype=dtype)
            kernel = lambda: st.stencil3d(x)
            emit({"kernel": "stencil3d", "n": n, "dtype": dt_name(dtype),
                  "equal_to_plain": bool(torch.equal(kernel(), st.stencil3d_torch(x))),
                  "ms": smoke.time_ms(kernel), "device_ms": smoke.device_ms_per_call(kernel, n=50),
                  **stencil_bound(n, dtype, bw)})
            del x


def time_prefill(smoke, runs, emit):
    from repro_torch import kernels
    from repro_torch.serving import make_prefill

    cfg, model, params = smoke.generate_model("recurrentgemma-2b", "bfloat16")
    b, s = smoke.GEN_CELLS["recurrentgemma-2b"]["batch"], 2600
    prompts = torch.randint(0, cfg.vocab, (b, s), generator=torch.Generator().manual_seed(3)).cuda()
    prefill = make_prefill(model, max_len=s + 32, attn_impl="auto")
    for _ in range(2):
        prefill(params, prompts)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    prefill(params, prompts)
    torch.cuda.synchronize()
    launches = kernels.launch_counts()["rglru_scan"]
    times = []
    for _ in range(runs):
        t0 = time.perf_counter()
        prefill(params, prompts)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    emit({"prefill": cfg.name, "dtype": "bfloat16", "n_layers": cfg.n_layers, "batch": b,
          "prompt_len": s, "prefill_ms": times, "prefill_ms_median": statistics.median(times),
          "rglru_scan_launches": launches})


# ---- --variants ---------------------------------------------------------------------
def start_build(tree, source, name, edits):
    """nvcc started on the tree's csrc/``source`` with ``edits`` ((line,
    replacement), each line asserted to be there once), into
    DIR/build/variants; returns (path, process)."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / source).read_text()
    for line, new in edits:
        assert src.count(line) == 1, f"{name}: line not found once: {line!r}"
        src = src.replace(line, new)
    out = tree / "build" / "variants" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    proc = subprocess.Popen([_build._nvcc(), *_build.FLAGS, f"-I{_build.CSRC}", "-o", str(out),
                             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc


def finish_build(name, out, proc, kernel):
    """The library and ptxas's registers and spill stores of ``kernel``."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    regs, spills, cur = [], [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            cur = kernel in line
        elif cur:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills.append(int(m.group(1)))
    return ctypes.CDLL(str(out)), {"ptxas_registers": regs, "ptxas_spill_stores": spills}


def occupancy(lib, fn, *args):
    f = getattr(lib, fn)
    f.argtypes = [ctypes.c_int] * len(args) + [ctypes.POINTER(ctypes.c_int)]
    f.restype = ctypes.c_int
    out = ctypes.c_int(0)
    rc = f(*args, ctypes.byref(out))
    return out.value if rc == 0 else None


def rglru_variant_call(lib, rs, a, bt):
    fn = lib.repro_rglru_scan
    fn.argtypes, fn.restype = rs._LIB.signatures["repro_rglru_scan"], ctypes.c_int
    b, t, w = a.shape
    y, hf = torch.empty_like(a), torch.empty(b, w, device="cuda")

    def call():
        err = fn(0 if a.dtype == torch.float32 else 1, a.data_ptr(), bt.data_ptr(), None,
                 y.data_ptr(), hf.data_ptr(), b, t, w, torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"rglru_scan variant launch failed: CUDA error {err}")
        return y, hf
    return call


def stencil_variant_call(lib, ps, x, run):
    fn = lib.repro_stencil3d
    fn.argtypes, fn.restype = ps.LIB.signatures["repro_stencil3d"], ctypes.c_int
    i, j, k = x.shape
    out = torch.empty_like(x)

    def call():
        err = fn(ps.DTYPE_CODE[x.dtype], x.data_ptr(), out.data_ptr(), i, j, k, run,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"stencil3d variant launch failed: CUDA error {err}")
        return out
    return call


def time_variants(tree, smoke, rs, st, g, bw, emit):
    from repro_torch.kernels import _paper_suite as ps

    builds = {}
    rg, pg = rs.GEOMETRY, ps.GEOMETRY  # the built constants, the lines the copies edit
    for c, stages in RGLRU_VARIANTS:
        name = f"rglru_c{c}_s{stages}"
        builds[name] = start_build(tree, "rglru_scan.cu", name, [
            (f"constexpr int kC = {rg['columns']};", f"constexpr int kC = {c};"),
            (f"constexpr int kStages = {rg['stages']};", f"constexpr int kStages = {stages};")])
    for tj, tk, rows, planes, cut in STENCIL_VARIANTS:
        name = f"stencil_j{tj}_k{tk}_r{rows}_p{planes}" + (f"_no_{cut}" if cut else "")
        builds[name] = start_build(tree, "paper_suite.cu", name, [
            (f"constexpr int kStJ = {pg['stencil_tile_j']};", f"constexpr int kStJ = {tj};"),
            (f"constexpr int kStK = {pg['stencil_tile_k']};", f"constexpr int kStK = {tk};"),
            (f"constexpr int kStRows = {pg['stencil_rows']};", f"constexpr int kStRows = {rows};"),
            (f"constexpr int kStPlanes = {pg['stencil_planes']};",
             f"constexpr int kStPlanes = {planes};")] + ([_ADDS] if cut else []))
    for c, stages in RGLRU_VARIANTS:
        name = f"rglru_c{c}_s{stages}"
        lib, ptx = finish_build(name, *builds[name], "rglru_kernel")
        for dtype in (torch.float32, torch.bfloat16):
            for b, t, w in RGLRU_SHAPES:
                a, bt = rglru_inputs(g, b, t, w, dtype)
                call = rglru_variant_call(lib, rs, a, bt)
                got = tuple(v.clone() for v in call())
                emit({"variant": {"kernel": "rglru_scan", "columns": c, "stages": stages},
                      "b": b, "t": t, "w": w, "dtype": dt_name(dtype),
                      "agrees_with_plain": rglru_agrees(
                          smoke, got, rs.rglru_torch(a, bt, return_final_state=True), dtype),
                      "equal_to_the_built_kernel": all(
                          torch.equal(u, v) for u, v in
                          zip(got, rs.rglru_scan(a, bt, return_final_state=True))),
                      "device_ms": smoke.device_ms_per_call(call, n=50),
                      "grid": b * -(-w // c), **ptx, **rglru_bound(b, t, w, dtype, bw)})
                del a, bt, got
    for tj, tk, rows, planes, cut in STENCIL_VARIANTS:
        name = f"stencil_j{tj}_k{tk}_r{rows}_p{planes}" + (f"_no_{cut}" if cut else "")
        lib, ptx = finish_build(name, *builds[name], "stencil3d_kernel")
        first = (tj, tk, rows, planes, cut) == STENCIL_VARIANTS[0]
        for n, dtype in itertools.product(CUBES if first else CUBES[-1:],
                                          (torch.float32, torch.bfloat16)):
            x = smoke._sum_input(g, n, n, n, dtype=dtype)
            want = st.stencil3d_torch(x)
            resident = occupancy(lib, "repro_stencil3d_blocks_per_sm", ps.DTYPE_CODE[dtype])
            for run in (STENCIL_RUNS[n] if first else [st.MAX_RUN]):
                call = stencil_variant_call(lib, ps, x, run)
                emit({"variant": {"kernel": "stencil3d", "tile_j": tj, "tile_k": tk,
                                  "rows": rows, "planes": planes, "run": run, "cut": cut},
                      "n": n, "dtype": dt_name(dtype), "equal_to_plain":
                      bool(torch.equal(call(), want)),
                      "device_ms": smoke.device_ms_per_call(call, n=50),
                      "blocks": -(-n // tk) * -(-n // tj) * -(-n // run),
                      "resident_blocks_per_sm": resident, **ptx,
                      **stencil_bound(n, dtype, bw)})
            del x, want


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--prefill-runs", type=int, default=5)
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_rglru_stencil: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    smoke = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import stencil3d as st

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for name in ("rglru_scan", "paper_suite"):
        _build.load(name)
    card = smoke.nvidia_smi_line()
    base = {"label": args.label, "tree": str(tree), "card": card}
    emit = lambda rec: print(json.dumps({**base, **rec}), flush=True)
    bw = HBM_BW  # a copy reads and writes: a read-mostly kernel can pass its rate
    emit({"copy_bytes_per_s": smoke.copy_bandwidth(), "bound_bytes_per_s": bw})
    g = torch.Generator(device="cuda").manual_seed(0)
    time_rglru(smoke, rs, g, bw, emit)
    time_stencil(smoke, st, g, bw, emit)
    torch.cuda.empty_cache()
    if args.prefill_runs:
        time_prefill(smoke, args.prefill_runs, emit)
        torch.cuda.empty_cache()
    if args.variants:
        time_variants(tree, smoke, rs, st, g, bw, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
