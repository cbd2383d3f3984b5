"""Build the port's CUDA sources with nvcc and load them through ctypes.

Each source under ``csrc/`` compiles to one shared library with a plain C
interface (no PyTorch headers, so a build takes seconds), for ``sm_90a``, into
``build/`` at the root of the checkout. The library's name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so a stale
build is never loaded and a finished one is reused. ``load(name)`` builds on first use; ``build_all()`` starts one nvcc
per source, all at once, and waits for them. ``Binding`` declares a source's C
entries and launches them, raising on a non-zero CUDA error code; where the
Python planner of a source assumes its tile and warp constants, the Binding
holds them and checks them against the library's ``repro_geometry`` when it
loads. Nothing is built at import.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = {"paged_attention": "paged_attention.cu", "quant_matmul": "quant_matmul.cu",
           "paper_suite": "paper_suite.cu", "flash_attention": "flash_attention.cu",
           "ssd_scan": "ssd_scan.cu", "rglru_scan": "rglru_scan.cu",
           "flash_attention_bwd": "flash_attention_bwd.cu"}
FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
    "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
]

# seconds each library took to build in this process (absent: loaded from disk)
build_seconds: Dict[str, float] = {}
_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found (PATH or /usr/local/cuda/bin): the CUDA kernels are "
            "built on the machine with the card"
        )
    return path


def library_path(name: str) -> Path:
    """The library's path; its name hashes the source, every header under
    ``csrc/`` (the sources include them) and the flags."""
    h = hashlib.sha256((CSRC / SOURCES[name]).read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(FLAGS).encode())
    digest = h.hexdigest()[:12]
    return BUILD_DIR / f"{name}_{digest}.so"


def build_log(name: str) -> str:
    """What nvcc printed (ptxas registers/spills included) for ``name``."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def _demangle(names: List[str]) -> List[str]:
    tool = shutil.which("cu++filt") or shutil.which("c++filt")
    if tool is None or not names:
        return names
    out = subprocess.run([tool], input="\n".join(names), capture_output=True, text=True)
    lines = out.stdout.splitlines()
    return lines if out.returncode == 0 and len(lines) == len(names) else names


def ptxas_report(name: str) -> Dict[str, Dict[str, int]]:
    """Registers and spill bytes of each kernel of ``name`` as ptxas printed
    them at build time (the ``-Xptxas -v`` of FLAGS): demangled function ->
    {"registers", "spill_stores", "spill_loads"}."""
    funcs: Dict[str, Dict[str, int]] = {}
    cur = None
    for line in build_log(name).splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for) '?([\w$]+)'?", line)
        if m:
            cur = funcs.setdefault(m.group(1), {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
    names = list(funcs)
    return dict(zip(_demangle(names), (funcs[n] for n in names)))


def _start(name: str):
    so = library_path(name)
    if so.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, so, time.perf_counter()


def _finish(started) -> None:
    name, proc, tmp, so, t0 = started
    out, _ = proc.communicate()
    so.with_suffix(".log").write_text(out)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{out}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    build_seconds[name] = time.perf_counter() - t0


def build_all() -> List[Path]:
    """Compile every source that has no current library, all nvcc processes in
    parallel; returns the library paths."""
    with _lock:
        started = [s for s in (_start(n) for n in SOURCES) if s is not None]
        try:
            for s in started:
                _finish(s)
        finally:
            for s in started:
                if s[1].poll() is None:
                    s[1].kill()
                    s[1].wait()
    return [library_path(n) for n in SOURCES]


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            started = _start(name)
            if started is not None:
                _finish(started)
            lib = ctypes.CDLL(str(library_path(name)))
            _libs[name] = lib
        return lib


def check_geometry(name: str, lib: ctypes.CDLL, expected: Dict[str, int]) -> None:
    """Raise unless ``lib``'s ``repro_geometry(int* out, int n)`` (the
    constants its kernels were built with) gives ``expected``'s values, in
    its order: the constants the source's Python planner assumes."""
    fn = lib.repro_geometry
    fn.argtypes, fn.restype = [ctypes.POINTER(ctypes.c_int), ctypes.c_int], ctypes.c_int
    buf = (ctypes.c_int * len(expected))()
    count = fn(buf, len(expected))
    if count != len(expected) or list(buf) != list(expected.values()):
        raise RuntimeError(
            f"{name}: the planner assumes {expected}, the library was built with "
            f"{list(buf)[:count]} ({count} values)"
        )


class Binding:
    """The C entries of one source, ``signatures`` mapping each entry's name
    to its argument types (the CUDA stream last, for the entries ``launch``
    calls); every entry returns a CUDA error code. The library is built and loaded on the first launch, and
    ``geometry`` (the constants the planner assumes, when given) is checked
    against it then."""

    def __init__(self, name: str, signatures: Dict[str, Sequence],
                 geometry: Optional[Dict[str, int]] = None):
        self.name, self.signatures, self.geometry = name, signatures, geometry
        self._lib: Optional[ctypes.CDLL] = None

    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = load(self.name)
            for fn, argtypes in self.signatures.items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            if self.geometry is not None:
                check_geometry(self.name, lib, self.geometry)
            self._lib = lib
        return self._lib

    def launch(self, fn: str, what: str, *args, device: torch.device) -> None:
        """Call entry ``fn`` with ``args`` and PyTorch's current stream of
        ``device``; raise if the launch was refused."""
        lib = self.lib()
        rc = getattr(lib, fn)(*args, torch.cuda.current_stream(device).cuda_stream)
        if rc != 0:
            msg = lib.repro_cuda_error_string(rc).decode()
            raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
