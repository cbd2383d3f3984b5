#!/usr/bin/env python3
"""Time the paper's Sum3D kernel (sum3d) of one checkout on one GPU, beside
``torch.sum``, so that two trees can be compared in one call.

    python3 scripts/time_sum3d.py [--tree DIR] [--label NAME] [--variants]

DIR (default: this checkout) is the root of a checkout of this repository:
its ``src/`` and its ``chip_smoke.py`` are imported, and its kernels are
built into DIR/build. Only public entry points are called (``sum3d``,
``sum3d_torch``, ``ops.sum3d``, ``MdSpan``), so any two trees of the port
time the same calls. Prints one JSON line per measurement, each with NAME
and the card's name and power limit (``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader``):

  copy    the device-to-device copy rate of a 1 GiB buffer (bytes read +
          written per second), for reference: a copy reads and writes, so
          a kernel that only reads can pass it, and the bounds do not use
          it;
  sum3d   the kernel at 96^3 (the reference's size), 95x97x99, 512^3
          (HBM-filling) and 509x511x513, f32 and bf16, on chip_smoke.py's
          mean-1 inputs, and at 512^3 on a view 4 (f32) / 2 (bf16) bytes off
          16: whether it agrees with the plain version (chip_smoke.py's gate,
          1e-5 * sum(|x|)), CUDA-event ms a call (median of 30, the host
          wrapper included), device ms a call (50 calls queued behind a
          sleep kernel), torch.sum(x, dtype=torch.float32)'s device ms on
          the same input, and the bytes bound (read x, write the f32 sum,
          over the data sheet's HBM3 rate, 3.35e12 B/s; the n additions over
          67e12 / s are far below);
  ops     ops.sum3d on an MdSpan (LayoutRight over the buffer) against the
          raw sum3d call at 96^3 f32: host microseconds a call (median of
          50, alternating, a synchronize before each), and the CUDA kernels
          one call launches (torch.profiler);
  sass    each Sum3D kernel of the tree's library (cuobjdump -sass): its
          global loads by opcode (LDG.E.128 is a 16-byte vector, LDG.E a
          4-byte scalar, LDG.E.U16 a 2-byte one), inside loops (a branch back
          to an earlier address closes one) and outside them, and its local
          memory loads and stores (spills).

With --variants (this tree's sources), the kernel is also built with other
choices (the source copied with lines edited, built with nvcc and
kernels/_build.FLAGS into DIR/build/variants, all at once) and called
through ctypes with the wrapper's arguments, each checked against the plain
version and timed (device ms) at every size above, beside ptxas's registers
and spills and the occupancy query's resident blocks an SM: the other fold
(an ordinary launch whose last block to arrive folds, found by an atomic
counter that it returns to 0), also on the parent's grid (at most 1024
blocks, one a 2048 elements: more than one wave, which a cooperative launch
cannot hold), 2 and 8 vectors in flight a thread, and each block a
contiguous run of vectors instead of the grid-stride walk.

Compare two trees in turns (A, B, B, A) within one call. Needs one GPU and
exits non-zero without one.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

SHAPES = [(96, 96, 96), (95, 97, 99), (512, 512, 512), (509, 511, 513)]
OFF16 = (512, 512, 512)  # also timed on a view one element off 16 bytes
F32_PEAK = 67e12  # f32 additions a second outside the tensor cores
HBM_BW = 3.35e12  # H100 SXM HBM3, bytes a second (data sheet): no kernel's reads beat it

# The other fold: an ordinary launch; every block writes its partial and
# counts itself on a device-global counter after a fence, and the last to
# arrive folds and returns the counter to 0 (calls on one stream only).
_LAST_BLOCK = [
    ("// Sum of v over the block, in a fixed order",
     "__device__ unsigned int g_sum3d_arrived = 0;\n\n"
     "// Sum of v over the block, in a fixed order"),
    ("""  if (threadIdx.x == 0) partials[blockIdx.x] = total;
  cooperative_groups::this_grid().sync();  // every partial written and visible
  if (blockIdx.x != 0) return;
""", """  __shared__ bool last;
  if (threadIdx.x == 0) {
    partials[blockIdx.x] = total;
    __threadfence();
    last = atomicAdd(&g_sum3d_arrived, 1u) == gridDim.x - 1;
    if (last) g_sum3d_arrived = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
"""),
    ("""  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sum3d_kernel<T>), grid,
                                     kSumThreads, args, 0, st);
""", """  (void)args;
  sum3d_kernel<T><<<grid, kSumThreads, 0, st>>>(xt, n, head, pt, ot);
  return cudaGetLastError();
"""),
]
# Each block a contiguous run of about nvec / grid vectors, its threads
# striding by kSumThreads within it.
_RUNS = [
    ("""  const int64_t stride = static_cast<int64_t>(gridDim.x) * kSumThreads;
  int64_t v = static_cast<int64_t>(blockIdx.x) * kSumThreads + threadIdx.x;
""", """  const int64_t stride = kSumThreads;
  const int64_t end = (static_cast<int64_t>(blockIdx.x) + 1) * nvec / gridDim.x;
  int64_t v = static_cast<int64_t>(blockIdx.x) * nvec / gridDim.x + threadIdx.x;
"""),
    ("  for (; v + (kSumVecs - 1) * stride < nvec; v += kSumVecs * stride) {\n",
     "  for (; v + (kSumVecs - 1) * stride < end; v += kSumVecs * stride) {\n"),
    ("  for (; v < nvec; v += stride) add_vec(acc, __ldg(xv + v));\n",
     "  for (; v < end; v += stride) add_vec(acc, __ldg(xv + v));\n"),
]


def dt_name(dtype):
    return str(dtype).split(".")[1]


def inputs(smoke, g, shape, dtype, off):
    x = smoke._sum_input(g, *shape, dtype=dtype)
    return smoke._offset_view(x, 1) if off else x


def cases():
    for shape in SHAPES:
        for dtype in (torch.float32, torch.bfloat16):
            yield shape, dtype, False
    for dtype in (torch.float32, torch.bfloat16):
        yield OFF16, dtype, True


def bound(x):
    nbytes, ops = x.numel() * x.element_size() + 4, x.numel()
    t_bytes, t_ops = nbytes / HBM_BW * 1e3, ops / F32_PEAK * 1e3
    return {"bytes": nbytes, "bound_ms": max(t_bytes, t_ops), "bound_ops_ms": t_ops,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def describe(x, shape, off):
    return {"shape": list(shape), "dtype": dt_name(x.dtype), "data_ptr_mod_16":
            x.data_ptr() % 16, "off16": off}


def time_sum3d(smoke, sm, g, emit):
    for shape, dtype, off in cases():
        x = inputs(smoke, g, shape, dtype, off)
        kernel = lambda: sm.sum3d(x)
        library = lambda: torch.sum(x, dtype=torch.float32)
        ok, _ = smoke._sum_tolerance(x)(kernel(), sm.sum3d_torch(x))
        emit({"kernel": "sum3d", **describe(x, shape, off), "agrees_with_plain": ok,
              "repeats_bit_for_bit": bool(torch.equal(kernel(), kernel())),
              "ms": smoke.time_ms(kernel), "device_ms": smoke.device_ms_per_call(kernel, n=50),
              "library_device_ms": smoke.device_ms_per_call(library, n=50), **bound(x)})
        del x


def cuda_kernels_in(fn):
    """The names of the CUDA kernels one call of ``fn`` launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]


def time_ops(smoke, sm, g, emit, reps=50):
    from repro_torch.core import Extents, LayoutRight, MdSpan
    from repro_torch.kernels import ops

    n3 = SHAPES[0][0]
    x = smoke._sum_input(g, n3, n3, n3)
    lay = LayoutRight(Extents.fully_dynamic(n3, n3, n3))
    calls = {"mdspan": lambda: ops.sum3d(MdSpan.from_dense(x, layout=lay)),
             "raw": lambda: sm.sum3d(x)}
    host = {k: [] for k in calls}
    for fn in calls.values():
        fn()
    for _ in range(reps):
        for key, fn in calls.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            host[key].append((time.perf_counter() - t0) * 1e6)
    torch.cuda.synchronize()
    emit({"ops": "sum3d", "shape": [n3] * 3, "dtype": "float32",
          "host_us_mdspan": statistics.median(host["mdspan"]),
          "host_us_raw": statistics.median(host["raw"]), "reps": reps,
          "cuda_kernels_a_call": cuda_kernels_in(calls["mdspan"])})


def sass_loads(lib):
    """{demangled-enough kernel name: its loads} for every function of
    ``lib`` whose name holds "sum3d"."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True, text=True,
                          check=True).stdout
    funcs, cur = {}, None
    for line in text.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            cur = funcs.setdefault(m.group(1), []) if "sum3d" in m.group(1) else None
            continue
        m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", line)
        if m and cur is not None:
            cur.append((int(m.group(1), 16), m.group(2)))
    out = {}
    for name, code in funcs.items():
        loops = []
        for addr, ins in code:
            b = re.search(r"\bBRA (?:`\()?(?:\.\w+ )?0x([0-9a-f]+)", ins)
            if b and int(b.group(1), 16) < addr:
                loops.append((int(b.group(1), 16), addr))
        inside, outside, local = Counter(), Counter(), Counter()
        for addr, ins in code:
            op = re.sub(r"^@!?U?P\w+\s+", "", ins).split()[0]
            if op.startswith("LDG"):
                (inside if any(a <= addr <= b for a, b in loops) else outside)[op] += 1
            elif op.startswith(("LDL", "STL")):
                local[op] += 1
        out[name] = {"ldg_in_loops": dict(inside), "ldg_outside_loops": dict(outside),
                     "local_memory": dict(local)}
    return out


# ---- --variants ---------------------------------------------------------------------
def start_build(tree, name, edits):
    """nvcc started on the tree's csrc/paper_suite.cu with ``edits`` ((text,
    replacement), each text asserted to be there once), into
    DIR/build/variants; returns (path, process)."""
    from repro_torch.kernels import _build

    src = (_build.CSRC / "paper_suite.cu").read_text()
    for text, new in edits:
        assert src.count(text) == 1, f"{name}: text not found once: {text!r}"
        src = src.replace(text, new)
    out = tree / "build" / "variants" / f"{name}.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cu = out.with_suffix(".cu")
    cu.write_text(src)
    proc = subprocess.Popen([_build._nvcc(), *_build.FLAGS, f"-I{_build.CSRC}", "-o", str(out),
                             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, proc


def finish_build(name, out, proc):
    """The library and ptxas's registers and spill stores of sum3d_kernel
    (f32, bf16)."""
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}:\n{log}")
    regs, spills, cur = [], [], False
    for line in log.splitlines():
        if "Compiling entry function" in line or "Function properties for" in line:
            cur = "sum3d_kernel" in line
        elif cur:
            m = re.search(r"Used (\d+) registers", line)
            if m:
                regs.append(int(m.group(1)))
            m = re.search(r"(\d+) bytes spill stores", line)
            if m:
                spills.append(int(m.group(1)))
    return ctypes.CDLL(str(out)), {"ptxas_registers": regs, "ptxas_spill_stores": spills}


def resident(lib, code):
    f = lib.repro_sum3d_blocks_per_sm
    f.argtypes, f.restype = [ctypes.c_int, ctypes.POINTER(ctypes.c_int)], ctypes.c_int
    out = ctypes.c_int(0)
    return out.value if f(code, ctypes.byref(out)) == 0 else None


def variant_call(lib, ps, x, grid):
    """A call of the variant's repro_sum3d with the wrapper's arguments and
    ``grid`` blocks."""
    fn = lib.repro_sum3d
    fn.argtypes, fn.restype = ps.LIB.signatures["repro_sum3d"], ctypes.c_int
    partials = torch.empty(grid, dtype=torch.float32, device="cuda")
    out = torch.empty((), dtype=torch.float32, device="cuda")

    def call():
        err = fn(ps.DTYPE_CODE[x.dtype], x.data_ptr(), x.numel(), grid, partials.data_ptr(),
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"sum3d variant launch failed: CUDA error {err}")
        return out
    return call


def time_variants(tree, smoke, sm, g, emit):
    from repro_torch.kernels import _paper_suite as ps
    from repro_torch.kernels.paged_attention import sm_count

    vecs = ps.GEOMETRY["sum3d_vectors"]
    vec_line = f"constexpr int kSumVecs = {vecs};\n"
    specs = {  # name -> (what it changes, edits, vectors in flight)
        "built": ({}, [], vecs),
        "fold_last_block": ({"fold": "last block"}, _LAST_BLOCK, vecs),
        "vecs2": ({"vectors": 2}, [(vec_line, "constexpr int kSumVecs = 2;\n")], 2),
        "vecs8": ({"vectors": 8}, [(vec_line, "constexpr int kSumVecs = 8;\n")], 8),
        "runs": ({"partition": "contiguous runs"}, _RUNS, vecs),
    }
    builds = {name: start_build(tree, name, edits) for name, (_, edits, _) in specs.items()}
    sms = sm_count(torch.device("cuda"))
    for name, (what, _, nv) in specs.items():
        lib, ptx = finish_build(name, *builds[name])
        for shape, dtype, off in cases():
            x = inputs(smoke, g, shape, dtype, off)
            want = sm.sum3d_torch(x)
            built = sm.sum3d(x)
            res = resident(lib, ps.DTYPE_CODE[dtype])
            # the planner's rule at nv vectors a thread: one wave, or a whole step a block
            vectors = x.numel() * x.element_size() // 16
            grids = {"plan": max(1, min(res * sms, -(-vectors // (sm.THREADS * nv))))}
            if name == "fold_last_block":  # the parent's grid: 1024 blocks at most,
                # one a 2048 elements (past one wave: no cooperative launch takes it)
                grids["parent_1024"] = max(1, min(1024, -(-x.numel() // 2048)))
            for grid_name, grid in grids.items():
                call = variant_call(lib, ps, x, grid)
                got = call().clone()
                emit({"variant": {**what, "grid": grid_name}, **describe(x, shape, off),
                      "grid": grid, "resident_blocks_per_sm": res,
                      "agrees_with_plain": smoke._sum_tolerance(x)(got, want)[0],
                      "equal_to_the_built_kernel": bool(torch.equal(got, built)),
                      "device_ms": smoke.device_ms_per_call(call, n=50), **ptx,
                      **bound(x)})
            del x


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(Path(__file__).resolve().parents[1]))
    ap.add_argument("--label", default="tree")
    ap.add_argument("--variants", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_sum3d: no CUDA device", file=sys.stderr)
        return 2
    tree = Path(args.tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    smoke = importlib.import_module("chip_smoke")
    from repro_torch.kernels import _build
    from repro_torch.kernels import sum3d as sm

    _build.load("paper_suite")
    card = smoke.nvidia_smi_line()
    base = {"label": args.label, "tree": str(tree), "card": card}
    emit = lambda rec: print(json.dumps({**base, **rec}), flush=True)
    emit({"copy_bytes_per_s": smoke.copy_bandwidth(), "bound_bytes_per_s": HBM_BW})
    g = torch.Generator(device="cuda").manual_seed(0)
    time_sum3d(smoke, sm, g, emit)
    time_ops(smoke, sm, g, emit)
    for name, loads in sass_loads(_build.library_path("paper_suite")).items():
        emit({"sass": name, **loads})
    torch.cuda.empty_cache()
    if args.variants:
        time_variants(tree, smoke, sm, g, emit)
    return 0


if __name__ == "__main__":
    sys.exit(main())
