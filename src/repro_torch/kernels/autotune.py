"""Kernel autotuner of the port: sweep-once block-shape selection for the paged
decode path (port of ``repro.kernels.autotune``, same names, same tuning-table
schema, so a table written by either package loads in the other).

The paged kernels expose the reference's block-shape knobs:

  * ``page_size``    — the LayoutPaged page extent, which is also the decode
                       kernel's K/V tile height;
  * ``block_pages``  — pages per compute block of the decode grid (the plain
                       blocked twin's gather granularity);
  * ``chunk_tokens`` — the prefill block shape (a chunk IS the chunk kernel's
                       Q tile; the engine buckets widths itself).

``resolve()`` consults a JSON tuning table on disk
(``artifacts/autotune_cache.json`` by default), keyed by

    {model_tag}/{kv_dtype}/b{batch_bucket}[/s{seq_bucket}]

(batch and sequence length bucketed to the next power of two). On a miss it
times the SAME ``ops.paged_decode_attention`` entry point the serve step calls
(host wrapper included: that is what the engine pays) over candidate
(page_size, block_pages) points, picks the fastest under the tie band and the
displacement rule, sweeps ``chunk_tokens`` at the winning page size against
``ops.paged_prefill_chunk_attention`` timings compared per token, writes the
table back and returns. Every later engine init with the same key is a pure
table lookup (no device work).

On a CUDA device the ``block_pages`` candidates collapse to ``(1,)``: the CUDA
decode checks the knob but ignores it (``paged_attention.paged_flash_decode``),
so sweeping it would time one kernel several times. There the knobs that move
the time are ``page_size`` and ``chunk_tokens``. On the CPU the full grid
stays, over the plain blocked twin. The sweep's pools hold the model's dtype
(what the engine's pools hold); the reference times f32 pools.

``EngineConfig(autotune=True)`` is the consumer (serving/engine/engine.py).
"""
from __future__ import annotations

import dataclasses
import json
import time
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

DEFAULT_CACHE_PATH = Path("artifacts/autotune_cache.json")
# schema 2: chunk_tokens is swept from real prefill-chunk timings; v1 entries
# reload as misses
CACHE_SCHEMA = 2

# candidate grids (small: the sweep runs at engine init on a cache miss)
PAGE_SIZE_CANDIDATES = (8, 16, 32)
BLOCK_PAGES_CANDIDATES = (1, 2, 4, 8)
# chunk widths tried at the winning page size, as page multiples (chunk
# boundaries stay page-aligned)
CHUNK_PAGE_MULTIPLIERS = (1, 2, 4)

_SWEEP_SEQ_PAGES = 16   # logical pages a sequence when the caller gives no seq_len
_SWEEP_REPS = 15
_SWEEP_WARMUP = 2

# candidates within this factor of the fastest count as ties, broken toward
# the simplest schedule (largest page_size, then smallest block_pages)
_SWEEP_TIE_X = 1.10

# ...and the tie-broken winner displaces the default schedule (page_size 16,
# unblocked) only when it is at least this much faster than it
_SWEEP_DISPLACE_X = 0.7


@dataclasses.dataclass(frozen=True)
class TunedPoint:
    """One tuning-table entry: the chosen block shapes plus provenance."""

    page_size: int
    block_pages: int
    chunk_tokens: int
    source: str          # "swept" | "default" | "cached"
    us_per_step: float   # winner's microbench step time (0 if default)

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)


def batch_bucket(batch: int) -> int:
    """Next power of two >= batch (min 1): nearby batch sizes share a key."""
    b = max(1, int(batch))
    return 1 << (b - 1).bit_length()


def seq_bucket(seq_len: int) -> int:
    """Next power of two >= seq_len (min 1), the same sharing law as batches."""
    s = max(1, int(seq_len))
    return 1 << (s - 1).bit_length()


def tuning_key(model_tag: str, kv_dtype: str, batch: int, seq_len: int = 0) -> str:
    key = f"{model_tag}/{kv_dtype}/b{batch_bucket(batch)}"
    if seq_len:
        key += f"/s{seq_bucket(seq_len)}"
    return key


def load_cache(path: Path) -> dict:
    try:
        raw = json.loads(Path(path).read_text())
    except (OSError, ValueError):
        return {}
    if raw.get("schema") != CACHE_SCHEMA:
        return {}
    return raw.get("entries", {})


def save_cache(path: Path, entries: dict) -> None:
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(
        json.dumps({"schema": CACHE_SCHEMA, "entries": entries}, indent=2, sort_keys=True)
        + "\n"
    )


def default_point(page_size: int = 16) -> TunedPoint:
    """The untuned engine's implicit choices."""
    return TunedPoint(page_size=page_size, block_pages=1, chunk_tokens=2 * page_size,
                      source="default", us_per_step=0.0)


def _sync(args) -> None:
    """Wait for the device the tensors in ``args`` live on (a no-op on the CPU,
    where every call returns finished)."""
    for a in args:
        if isinstance(a, torch.Tensor) and a.is_cuda:
            torch.cuda.synchronize(a.device)
            return


def _time_decode(fn, args, reps: int = _SWEEP_REPS) -> float:
    """Min wall time (seconds) of one call, host wrapper included, after the
    warm-up; the device is synchronised after the warm-up and around each rep.
    Min, not median: host-timing noise only adds time."""
    for _ in range(_SWEEP_WARMUP):
        fn(*args)
    _sync(args)
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn(*args)
        _sync(args)
        ts.append(time.perf_counter() - t0)
    return float(np.min(ts))


def _geometry(model_cfg, batch: int):
    hq = max(1, int(model_cfg.n_heads))
    hkv = max(1, int(model_cfg.n_kv_heads or model_cfg.n_heads))
    return hq, hkv, int(model_cfg.head_dim), batch_bucket(batch)


def _tensor(a: np.ndarray, dtype, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device=device, dtype=dtype)


def _tables(b: int, max_pages: int, device) -> torch.Tensor:
    return _tensor(1 + np.arange(b * max_pages, dtype=np.int32).reshape(b, max_pages),
                   torch.int32, device)


def sweep_chunk_tokens(
    model_cfg,
    *,
    kv_dtype: str = "f32",
    batch: int = 8,
    seq_len: int = 0,
    page_size: int = 16,
    multipliers: Sequence[int] = CHUNK_PAGE_MULTIPLIERS,
    device=None,
) -> int:
    """Pick ``chunk_tokens`` from prefill-chunk timings at a fixed page size:
    ``ops.paged_prefill_chunk_attention`` (the entry the chunked prefill step
    calls) at C = m * page_size against a half-resident past, compared per
    token. The tie band breaks toward 2 * page_size."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine.kvquant import KV_DTYPES

    dev = resolve_device(device)
    dt = model_cfg.param_dtype
    hq, hkv, d, b = _geometry(model_cfg, batch)
    ps = int(page_size)
    spec = KV_DTYPES[kv_dtype]

    max_pages = -(-seq_len // ps) if seq_len else _SWEEP_SEQ_PAGES
    max_pages = max(max_pages, max(multipliers))  # a chunk must fit the table
    num_pages = b * max_pages + 1
    rng = np.random.default_rng(0)
    tables = _tables(b, max_pages, dev)
    # mid-prefill regime: half the context resident, the chunk is the present
    cursors = torch.full((b,), (max_pages // 2) * ps, dtype=torch.int32, device=dev)
    pool = _tensor(rng.standard_normal((num_pages, hkv, ps, d)), torch.float32, dev)
    timed: list = []
    for m in multipliers:
        c = m * ps
        q = _tensor(rng.standard_normal((b, hq, c, d)), dt, dev)
        pres = _tensor(rng.standard_normal((b, hkv, c, d)), dt, dev)
        if spec is None:
            fn = ops.paged_prefill_chunk_attention
            args = (q, pres, pres, pool.to(dt), pool.to(dt), tables, cursors)
        else:
            enc = spec.encode_pages(pool)

            def fn(*a, _bits=spec.bits):
                return ops.paged_prefill_chunk_attention_quant(*a, bits=_bits)

            args = (q, pres, pres, enc["q"], enc["scale"], enc["q"], enc["scale"], tables,
                    cursors)
        timed.append((c, _time_decode(fn, args) / c))  # seconds per token
    t_min = min(t for _, t in timed)
    ties = [c for c, t in timed if t <= _SWEEP_TIE_X * t_min]
    return 2 * ps if 2 * ps in ties else ties[0]


def sweep(
    model_cfg,
    *,
    kv_dtype: str = "f32",
    batch: int = 8,
    seq_len: int = 0,
    page_sizes: Sequence[int] = PAGE_SIZE_CANDIDATES,
    block_pages: Sequence[int] = BLOCK_PAGES_CANDIDATES,
    device=None,
) -> TunedPoint:
    """Time the decode over the candidate grid; return the fastest
    (page_size, block_pages) as a TunedPoint, its chunk_tokens swept at the
    winning page size.

    Times ``ops.paged_decode_attention`` (``_quant`` for intN dtypes), the
    entry the serve step calls, on synthetic pools shaped from the model's
    attention geometry (Hq / Hkv / head_dim), one token a sequence, every
    sequence at full length; ``seq_len`` shapes the pools to the caller's
    sized context (pages = ceil(seq_len / page_size)), else 16 pages. On a
    CUDA device only block_pages 1 is timed (the kernel ignores the knob)."""
    from repro_torch.kernels import ops
    from repro_torch.serving.engine.kvquant import KV_DTYPES

    dev = resolve_device(device)
    dt = model_cfg.param_dtype
    hq, hkv, d, b = _geometry(model_cfg, batch)
    spec = KV_DTYPES[kv_dtype]
    if dev.type == "cuda":
        block_pages = (1,)

    points: list[TunedPoint] = []
    rng = np.random.default_rng(0)
    for ps in page_sizes:
        max_pages = -(-seq_len // ps) if seq_len else _SWEEP_SEQ_PAGES
        num_pages = b * max_pages + 1
        q = _tensor(rng.standard_normal((b, hq, 1, d)), dt, dev)
        tables = _tables(b, max_pages, dev)
        lens = torch.full((b,), max_pages * ps, dtype=torch.int32, device=dev)
        pool = _tensor(rng.standard_normal((num_pages, hkv, ps, d)), torch.float32, dev)
        if spec is None:
            args = (q, pool.to(dt), pool.to(dt), tables, lens)

            def make(bp):
                return lambda *a: ops.paged_decode_attention(*a, block_pages=bp)
        else:
            enc = spec.encode_pages(pool)
            args = (q, enc["q"], enc["scale"], enc["q"], enc["scale"], tables, lens)

            def make(bp, _bits=spec.bits):
                return lambda *a: ops.paged_decode_attention_quant(*a, bits=_bits,
                                                                    block_pages=bp)

        for bp in block_pages:
            if bp > max_pages:
                continue
            t = _time_decode(make(bp), args)
            points.append(TunedPoint(page_size=ps, block_pages=bp, chunk_tokens=2 * ps,
                                     source="swept", us_per_step=t * 1e6))
    if not points:
        return default_point()
    t_min = min(p.us_per_step for p in points)
    ties = [p for p in points if p.us_per_step <= _SWEEP_TIE_X * t_min]
    best = max(ties, key=lambda p: (p.page_size, -p.block_pages))
    anchor_ps = 16 if 16 in page_sizes else page_sizes[0]
    anchor = next((p for p in points if p.page_size == anchor_ps and p.block_pages == 1), None)
    if anchor is not None and best.us_per_step > _SWEEP_DISPLACE_X * anchor.us_per_step:
        best = anchor
    return dataclasses.replace(best, chunk_tokens=sweep_chunk_tokens(
        model_cfg, kv_dtype=kv_dtype, batch=batch, seq_len=seq_len,
        page_size=best.page_size, device=dev,
    ))


def resolve(
    model_cfg,
    *,
    kv_dtype: str = "f32",
    batch: int = 8,
    seq_len: int = 0,
    page_size: Optional[int] = None,
    cache_path: Path | str | None = None,
    allow_sweep: bool = True,
    device=None,
) -> TunedPoint:
    """The engine-init entry point: cached lookup, sweep once on a miss (on
    ``device``, CUDA unless the caller names one).

    ``page_size`` pins the layout extent: the sweep then searches only at
    that page size, and a cached entry tuned at another page size is
    projected onto the pinned one. ``allow_sweep=False`` degrades a miss to
    the default point (no device work)."""
    path = Path(cache_path) if cache_path is not None else DEFAULT_CACHE_PATH
    tag = getattr(model_cfg, "name", "model")
    key = tuning_key(tag, kv_dtype, batch, seq_len)
    entries = load_cache(path)
    hit = entries.get(key)
    if hit is not None:
        point = TunedPoint(**{**hit, "source": "cached"})
        if page_size and point.page_size != page_size:
            # the cached chunk width was swept at another page size: fall back
            # to the page-aligned default rather than re-timing
            point = dataclasses.replace(point, page_size=page_size,
                                        chunk_tokens=2 * page_size)
        return point
    if not allow_sweep:
        return default_point(page_size or 16)
    point = sweep(
        model_cfg, kv_dtype=kv_dtype, batch=batch, seq_len=seq_len,
        page_sizes=(page_size,) if page_size else PAGE_SIZE_CANDIDATES, device=device,
    )
    entries[key] = dataclasses.replace(point, source="swept").as_dict()
    save_cache(path, entries)
    return point
