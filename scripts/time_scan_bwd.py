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
(``torch.profiler`` over 5 calls): for ssd_scan_bwd pass_kernel (the state
and adjoint passes, one launch), lam_kernel and s_kernel (the chunk kernels
of a head group), fold_kernel (more than one group) and fold_da_kernel. For
ssd_scan_bwd each line also carries the head groups, the workspace bytes a
call and the chunk kernels' blocks an SM by the occupancy query.

With ``--phases`` (this tree's csrc/ssd_scan_bwd.cu), where the SSD
backward's time goes: the source is copied with one change at a time (a
textual edit at an anchor, each asserted to be there once), built with nvcc
and ``_build.FLAGS`` into DIR/build/variants, bound in the wrapper's place
and timed (device ms, and ms by kernel) at each SSD case: stages4
(pass_kernel's ring 4 deep: right, checked against the plain twin),
no_store (the passes write the state of their last chunk only), no_update
(the passes skip the state's product) and no_stage (the passes stage their
first chunk only); the cut ones are wrong and only timed.

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
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(Path(__file__).resolve().parent))
from time_flash_bwd import kernel_split  # noqa: E402


def digest(tensors):
    return hashlib.sha256(b"".join(t.contiguous().view(torch.uint8).cpu().numpy().tobytes()
                                   for t in tensors if t is not None)).hexdigest()


# variant -> [(anchor in csrc/ssd_scan_bwd.cu, replacement)]: --phases' copies
_STORE = "        put_row16(out + (16 * warp + g + 8 * r) * p.np"
_STAGE_CALLS = ("    stage(vs_at(s), ld, v + (tok * p.heads + hh) * P",
          "    stage_dt(dts_at(s), p.dt, tok, p.heads, hh, rows);\n    cp_async_commit();\n  };")
PHASES = {
    "stages4": [("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "no_store": [(_STORE, "        if (it == p.nc - 1) " + _STORE.lstrip())],
    "no_update": [("    const float decay = exp2f(sc.last);\n",
                   "    const float decay = exp2f(sc.last);\n    if (it >= 0) {\n"
                   "      __syncthreads();\n      continue;\n    }\n")],
    "no_stage": [(_STAGE_CALLS[0], "    if (it < kStages - 1) {\n" + _STAGE_CALLS[0]),
                 (_STAGE_CALLS[1], _STAGE_CALLS[1].replace("    cp_async_commit();",
                                                           "    }\n    cp_async_commit();"))],
}


def build_cut(tree, name, edits):
    """This tree's csrc/ssd_scan_bwd.cu with ``edits`` applied, built into
    DIR/build/variants; returns the library's path."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / _build.SOURCES["ssd_scan_bwd"]).read_text()
    for anchor, new in edits:
        assert src.count(anchor) == 1, f"{name}: anchor not found once: {anchor!r}"
        src = src.replace(anchor, new)
    out = tree / "build" / "variants" / f"ssd_scan_bwd_{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cut = out.with_suffix(".cu")
    cut.write_text(src)
    proc = subprocess.run([_build._nvcc(), *_build.FLAGS, f"-I{_build.CSRC}", "-o", str(out),
                           str(cut)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{proc.stdout}{proc.stderr}")
    return out


def bind_cut(ss, path):
    """The library at ``path`` with the backward binding's signatures."""
    import ctypes

    lib = ctypes.CDLL(str(path))
    for fn, argtypes in ss._BWD_LIB.signatures.items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def time_phases(tree, smoke, ss, card, label, dtypes):
    """--phases: each PHASES copy in the wrapper's place, at the SSD cases."""
    real = ss._BWD_LIB.lib()
    for name, edits in PHASES.items():
        ss._BWD_LIB._lib = bind_cut(ss, build_cut(tree, name, edits))
        try:
            for i, case in enumerate(smoke.SSD_BWD_CASES):
                for dtype in dtypes:
                    g = torch.Generator(device="cuda").manual_seed(300 + i)
                    c = smoke.scan_bwd_case("ssd", case, dtype, g)
                    rec = {"label": label, "nvidia_smi": card, "phase_cut": name,
                           "case": case[0], "dtype": str(dtype).split(".")[1],
                           "device_ms": smoke.device_ms_per_call(c.kernel, n=20),
                           "kernel_device_ms": kernel_split(c.kernel)}
                    if "stages" in name:
                        got, want = c.kernel(), c.plain()
                        rec["agrees_with_plain"] = all(
                            smoke._grad_excess(a, w, a.dtype)[1] <= 0
                            for a, w in zip(got, want) if a is not None)
                    print(json.dumps(rec), flush=True)
                    del c
                    torch.cuda.empty_cache()
        finally:
            ss._BWD_LIB._lib = real


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
    ap.add_argument("--phases", action="store_true",
                    help="time copies of this tree's SSD backward with one phase changed or cut")
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
    if args.phases:
        time_phases(tree, smoke, ss, card, args.label, dtypes)
        return 0
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
            if kind == "ssd":
                sh = c.shape
                if hasattr(ss, "bwd_head_groups"):
                    rec["head_groups"] = ss.bwd_head_groups(sh["b"], sh["t"], sh["h"])
                    rec["workspace_bytes"] = ss.bwd_workspace_bytes(sh["b"], sh["t"], sh["h"],
                                                                    sh["n"])
                    rec["chunk_blocks_per_sm"] = ss.bwd_blocks_per_sm(dtype, sh["n"],
                                                                      torch.device("cuda"))
            if args.profile:
                rec["kernel_device_ms"] = kernel_split(call)
            print(json.dumps(rec), flush=True)
            del c
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
