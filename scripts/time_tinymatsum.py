#!/usr/bin/env python3
"""Time the TinyMatrixSum kernels (static and dynamic extents, paper Fig. 5)
of one checkout on one GPU, so that two trees can be compared in one call,
and read the compute loops' machine code.

    python3 scripts/time_tinymatsum.py [--tree DIR] [--label NAME] [--sass]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` and its ``chip_smoke.py`` are imported, and its kernels are
built into DIR/build. Only public entry points are called
(``tinymatsum_static``, ``tinymatsum_dynamic``, ``tinymatsum_torch``), so
any two trees of the port time the same calls. Prints one JSON line per
measurement, each with NAME and the card's name and power limit
(``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``):

  copy        the device-to-device copy rate of a 1 GiB buffer (bytes read
              + written per second), for reference only;
  tinymatsum  each kernel at (N, J, K) = (8M, 3, 3), the reference's (100k,
              3, 3) and (200k, 3, 3), and (1M, 8, 8), f32 and bf16, inputs
              of N(0, 1): CUDA-event ms a call (median of 30, host wrapper
              included), device ms a call (50 calls queued behind a sleep
              kernel), the same two for torch.add on the same tensors, the
              bytes bound (3 N J K elements over the data sheet's HBM3 rate) and whether
              the output equals the plain version's bits; then the static /
              dynamic device-ms ratio of each case.

With --sass, the tree's paper-suite library is disassembled (cuobjdump) and
one line per kernel instantiation (f32 and bf16 at 3 x 3 and 8 x 8, static
and dynamic) gives its compute loop: the outermost loop without a barrier
that holds the o + s adds (FADD), one reading shared memory where there is
one (the dynamic kernel's unstaged loop over global memory is not its
compute loop); its nested loops; and instructions per matrix: the static
kernels' loops have no runtime inner loops, so that count is exact; for the
dynamic ones each inner loop is counted at the trip count (J, K) gives it,
its straight-line remainder in full (an upper bound). A kernel with no such
loop (one matrix a thread, unrolled: the parent's static one) is counted
whole, less its NOP and BRA padding.

With --plans (trees that have ``plan_tinymatsum``), both kernels at (8M, 3,
3) f32 and bf16 and (1M, 8, 8) f32 under the planner's other choices: spans
of 4, 8 and 16 KB an operand (bn matrices), each with as many blocks as the
kernel's occupancy fits on the card, device ms each; then the planner's own
plan beside the same plan with the grid at the threads' limit (2048 threads
an SM, more blocks than the registers let in at once).

Compare two trees in turns (A, B, B, A) within one call. Needs one GPU and
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

HBM_BW = 3.35e12  # H100 SXM HBM3, bytes a second (data sheet): the bytes bounds' rate

CASES = [(8_000_000, 3, 3), (100_000, 3, 3), (200_000, 3, 3), (1_000_000, 8, 8)]
SASS_CASES = [("f", 3, 3), ("f", 8, 8), ("13__nv_bfloat16", 3, 3), ("13__nv_bfloat16", 8, 8)]
ADDR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")


def parse_sass(text: str):
    """{mangled function name: [(address, instruction), ...]}"""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = ADDR.search(line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    return funcs


def loops_of(code):
    """Loops as (first, last) instruction indices: a branch back to an
    earlier address closes one."""
    index = {addr: i for i, (addr, _) in enumerate(code)}
    out = []
    for i, (addr, ins) in enumerate(code):
        m = re.search(r"\bBRA (?:`\()?(?:\.\w+ )?0x([0-9a-f]+)", ins)
        if m and int(m.group(1), 16) < addr and int(m.group(1), 16) in index:
            out.append((index[int(m.group(1), 16)], i))
    return out


def compute_loop(code, jk_of_row):
    """The compute loop's tree and instructions per matrix (see the module
    docstring); ``jk_of_row`` = (J, K). Loop levels count from the innermost:
    the k loop runs K // (its adds) times, the j loop J times, a loop above
    them (over a thread's matrices) once a matrix; where the nest has no
    such level, a thread's one matrix also costs the code outside loops."""
    loops = [lp for lp in loops_of(code)
             if not any("BAR.SYNC" in code[i][1] for i in range(lp[0], lp[1] + 1))]
    fadd = lambda a, b: sum("FADD" in code[i][1] for i in range(a, b + 1))
    size = lambda lp: lp[1] - lp[0] + 1
    outside = sum(ins.split()[0] not in ("NOP", "BRA") for _, ins in code)
    holding = [lp for lp in loops if fadd(*lp)]
    if not holding:  # one matrix a thread, unrolled: the whole function is its code
        return {"straight_line": True, "loop_fadd": fadd(0, len(code) - 1),
                "instructions_per_matrix": outside}
    lds = lambda lp: any("LDS" in code[i][1] for i in range(lp[0], lp[1] + 1))
    outer = max(holding, key=lambda lp: (lds(lp), fadd(*lp), size(lp)))
    j, k = jk_of_row

    def children(lp):
        inner = [c for c in loops if c != lp and lp[0] <= c[0] and c[1] <= lp[1]]
        return [c for c in inner
                if not any(d != c and d[0] <= c[0] and c[1] <= d[1] for d in inner)]

    def walk(lp):  # (instructions a trip, levels, tree)
        kids = [(c, *walk(c)) for c in children(lp)]
        ins, tree = size(lp) - sum(size(c) for c, *_ in kids), []
        for c, c_ins, c_levels, c_tree in kids:
            per_trip = fadd(*c) - sum(fadd(*d) for d in children(c))
            trips = k // max(1, per_trip) if c_levels == 1 else j
            ins += trips * c_ins
            tree.append({"instructions": size(c), "fadd": fadd(*c), "trips": trips,
                         "inner": c_tree})
        return ins, 1 + max((lv for _, _, lv, _ in kids), default=0), tree

    ins, levels, tree = walk(outer)
    if levels == 1:  # an unrolled nest: fadd / (J K) matrices a trip
        per_matrix = ins / (fadd(*outer) / (j * k))
    elif levels == 2:  # the j loop is the outermost: one matrix a thread
        per_matrix = j * ins + outside - size(outer)
    else:
        per_matrix = ins
    return {"loop_instructions": size(outer), "loop_fadd": fadd(*outer), "levels": levels,
            "nested": tree, "instructions_per_matrix": per_matrix, "upper_bound": levels > 1,
            "lds": sum("LDS" in code[i][1] for i in range(outer[0], outer[1] + 1)),
            "sts": sum("STS" in code[i][1] for i in range(outer[0], outer[1] + 1))}


def sass_lines(lib: Path):
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs = parse_sass(text)
    for t, j, k in SASS_CASES:
        for kind, pat in (("static", f"tinymatsum_static_kernelI{t}Li{j}ELi{k}E"),
                          ("dynamic", f"tinymatsum_dynamic_kernelI{t}E")):
            name = next((n for n in funcs if pat in n), None)
            if name is None:
                continue
            yield {"sass": kind, "dtype": "float32" if t == "f" else "bfloat16", "J": j, "K": k,
                   "function_instructions": len(funcs[name]),
                   **compute_loop(funcs[name], (j, k))}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--plans", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_tinymatsum: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    smoke = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build
    from repro_torch.kernels import tinymatsum as tm

    _build.build_all()
    card = smoke.nvidia_smi_line()
    base = {"label": args.label, "tree": str(tree), "card": card}
    emit = lambda rec: print(json.dumps({**base, **rec}), flush=True)
    bw = HBM_BW  # a copy reads and writes: a read-mostly kernel can pass its rate
    emit({"copy_bytes_per_s": smoke.copy_bandwidth(), "bound_bytes_per_s": bw})
    g = torch.Generator(device="cuda").manual_seed(0)
    for n, j, k in CASES:
        for dtype in (torch.float32, torch.bfloat16):
            o = torch.randn(n, j, k, generator=g, device="cuda").to(dtype)
            s = torch.randn(n, j, k, generator=g, device="cuda").to(dtype)
            want = tm.tinymatsum_torch(o, s)
            nbytes = 3 * o.numel() * o.element_size()
            add = lambda: torch.add(o, s)
            lib = {"add_ms": smoke.time_ms(add), "add_device_ms": smoke.device_ms_per_call(add, n=50)}
            device = {}
            for name, fn in (("tinymatsum_static", tm.tinymatsum_static),
                             ("tinymatsum_dynamic", tm.tinymatsum_dynamic)):
                kernel = lambda: fn(o, s)
                equal = torch.equal(kernel(), want)
                device[name] = smoke.device_ms_per_call(kernel, n=50)
                emit({"kernel": name, "N": n, "J": j, "K": k, "dtype": str(dtype).split(".")[1],
                      "ms": smoke.time_ms(kernel), "device_ms": device[name], **lib,
                      "bound_ms": nbytes / bw * 1e3, "bytes": nbytes, "equal_to_plain": equal,
                      "device_over_add": device[name] / lib["add_device_ms"]})
            emit({"ratio": "static_over_dynamic_device_ms", "N": n, "J": j, "K": k,
                  "dtype": str(dtype).split(".")[1],
                  "value": device["tinymatsum_static"] / device["tinymatsum_dynamic"]})
            del o, s, want
            torch.cuda.empty_cache()
    if args.plans:
        from repro_torch.kernels import _paper_suite as ps
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        for n, j, k, dtype in ((8_000_000, 3, 3, torch.float32), (8_000_000, 3, 3, torch.bfloat16),
                               (1_000_000, 8, 8, torch.float32)):
            o = torch.randn(n, j, k, generator=g, device="cuda").to(dtype)
            s = torch.randn(n, j, k, generator=g, device="cuda").to(dtype)
            esz, code = o.element_size(), ps.DTYPE_CODE[dtype]
            row = tm.tiny_stride(j * k, esz) * esz
            unit = 16 // math.gcd(j * k * esz, 16)
            for span in (4096, 8192, 16384):
                bn = max(unit, span // row // unit * unit)
                smem = tm.stage_bytes(j, k, esz, bn)
                rec = {"span_bytes": span, "bn": bn, "smem": smem, "N": n, "J": j, "K": k,
                       "dtype": str(dtype).split(".")[1]}
                for name, fn, static in (("static", tm.tinymatsum_static, True),
                                         ("dynamic", tm.tinymatsum_dynamic, False)):
                    per_sm = ps.tinymatsum_blocks_per_sm(code, static, j, k, smem, o.device)
                    plan = tm.TinyPlan(bn, min(-(-n // bn), per_sm * sms), True)
                    rec[f"{name}_grid"] = plan.grid
                    rec[f"{name}_device_ms"] = smoke.device_ms_per_call(
                        lambda: fn(o, s, plan=plan), n=50)
                emit(rec)
            thread_limit = 2048 // ps.GEOMETRY["threads"]  # blocks an SM by threads alone
            for name, fn, static in (("static", tm.tinymatsum_static, True),
                                     ("dynamic", tm.tinymatsum_dynamic, False)):
                plan = tm.plan_for(o, s, torch.empty_like(o), static)
                wide = tm.TinyPlan(plan.bn, min(-(-n // plan.bn), thread_limit * sms), True)
                emit({"oversubscribed": name, "N": n, "J": j, "K": k,
                      "dtype": str(dtype).split(".")[1], "plan": vars(plan),
                      "device_ms": smoke.device_ms_per_call(lambda: fn(o, s, plan=plan), n=50),
                      "grid_at_thread_limit": wide.grid, "device_ms_at_thread_limit":
                      smoke.device_ms_per_call(lambda: fn(o, s, plan=wide), n=50)})
            del o, s
            torch.cuda.empty_cache()
    if args.sass:
        for rec in sass_lines(_build.library_path("paper_suite")):
            emit(rec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
