"""Serving telemetry: request lifecycle tracing + a streaming metrics registry.

Host-only Python, kept as its own copy of ``repro.serving.telemetry`` so the
port imports nothing of the reference package.

The mdspan paper's thesis is that orthogonal concerns — layout, element
representation — become cheap when they are expressed as composable policies
instead of scattered special cases. Observability is the same kind of concern:
this module makes it a LAYER the engine threads through its existing event
points rather than timers sprinkled into the hot path.

Two halves:

**EngineTrace** — a bounded ring buffer of timestamped lifecycle events,
emitted at every engine transition (enqueue, admit, chunk landings, CoW,
preemption, fused-window start/end, EOS/finish/reject, slow steps). Emission
is host-only and event-driven: the decode hot path emits NOTHING per token, so
the zero-per-token-D2H property of the fused step is untouched, and when the
trace is off (``EngineConfig.trace=False`` -> ``engine.trace is None``) every
site is a single ``is not None`` check. ``to_chrome()`` exports Chrome
trace-event JSON — one track per batch slot plus a scheduler track — that
opens directly in Perfetto (https://ui.perfetto.dev) or chrome://tracing.

**MetricsRegistry** — counters, gauges, and fixed-log-bucket histograms that
replace the engine's unbounded per-step Python lists. A histogram holds one
int per bucket (a few hundred total), so p50/p95/p99 survive million-step runs
in O(1) memory; ``percentile()`` is exact to within one bucket's relative
width (~7.5% at the default 32 buckets/decade — the tolerance the tests pin).

``validate_chrome_trace`` is the schema checker CI and the tests share: every
event carries the required keys, timestamps are sorted, and B/E duration
events pair up stack-wise per track.
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from collections import deque
from typing import Any, Dict, List, Optional, Tuple


# ---------------------------------------------------------------------------------
# streaming metrics: counters / gauges / log-bucket histograms
# ---------------------------------------------------------------------------------
class Counter:
    """Monotonic event count. O(1) memory, survives any run length."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Gauge:
    """Last-written value (pool occupancy, queue depth, ...)."""

    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)

    def reset(self) -> None:
        self.value = 0.0


class Histogram:
    """Fixed log-bucket histogram: percentiles from O(1) memory.

    Buckets are geometric: ``buckets_per_decade`` per power of ten between
    ``lo`` and ``hi`` (values outside clamp into under/overflow buckets, their
    exact min/max still tracked). ``observe`` is a log10 + one increment — no
    allocation, so a million-step run costs the same memory as a ten-step one.
    ``percentile`` linearly interpolates inside the covering bucket, so its
    relative error is bounded by the bucket width ratio (10^(1/32) - 1 ~ 7.5%
    at the default resolution); the unit tests check this bound against exact
    numpy percentiles on recorded traces.
    """

    __slots__ = ("lo", "hi", "bpd", "_n", "counts", "count", "total",
                 "min", "max")

    def __init__(self, lo: float = 1e-7, hi: float = 1e3,
                 buckets_per_decade: int = 32):
        if not (lo > 0 and hi > lo):
            raise ValueError("need 0 < lo < hi")
        self.lo, self.hi, self.bpd = lo, hi, buckets_per_decade
        decades = math.log10(hi / lo)
        self._n = int(math.ceil(decades * buckets_per_decade))
        self.reset()

    def reset(self) -> None:
        # [underflow] + n log buckets + [overflow]
        self.counts = [0] * (self._n + 2)
        self.count = 0
        self.total = 0.0
        self.min = math.inf
        self.max = -math.inf

    def _bucket(self, v: float) -> int:
        if v < self.lo:
            return 0
        if v >= self.hi:
            return self._n + 1
        return 1 + int(math.log10(v / self.lo) * self.bpd)

    def _edges(self, b: int) -> Tuple[float, float]:
        """(lower, upper) value edges of log bucket ``b`` (1-based)."""
        lo = self.lo * 10.0 ** ((b - 1) / self.bpd)
        hi = self.lo * 10.0 ** (b / self.bpd)
        return lo, hi

    def observe(self, v: float) -> None:
        v = float(v)
        self.counts[self._bucket(v)] += 1
        self.count += 1
        self.total += v
        if v < self.min:
            self.min = v
        if v > self.max:
            self.max = v

    @property
    def mean(self) -> float:
        return self.total / self.count if self.count else 0.0

    def percentile(self, q: float) -> float:
        """Approximate q-th percentile (0..100) — within one bucket width of
        the exact order statistic; clamped to the observed [min, max]."""
        if not self.count:
            return 0.0
        target = (q / 100.0) * self.count
        seen = 0.0
        for b, c in enumerate(self.counts):
            if c == 0:
                continue
            if seen + c >= target:
                if b == 0:
                    return self.min
                if b == self._n + 1:
                    return self.max
                lo, hi = self._edges(b)
                frac = (target - seen) / c
                est = lo + frac * (hi - lo)
                return min(max(est, self.min), self.max)
            seen += c
        return self.max

    def snapshot(self) -> Dict[str, float]:
        return {
            "count": self.count,
            "mean": self.mean,
            "p50": self.percentile(50),
            "p95": self.percentile(95),
            "p99": self.percentile(99),
            "min": self.min if self.count else 0.0,
            "max": self.max if self.count else 0.0,
        }


class MetricsRegistry:
    """Named counters/gauges/histograms behind one create-or-get surface.

    The engine's ``metrics()`` is a ``snapshot()`` over this registry plus the
    allocator's stats — the flat dict the bench suite consumes is unchanged,
    but nothing underneath it grows with the number of steps.
    """

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str, **kw) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(**kw)
        return h

    def reset(self) -> None:
        """Zero every instrument, keeping registrations (and histogram bucket
        geometry) intact — what ``ServeEngine.reset_metrics`` calls between a
        bench rehearsal and its measured pass."""
        for c in self._counters.values():
            c.reset()
        for g in self._gauges.values():
            g.reset()
        for h in self._histograms.values():
            h.reset()

    def snapshot(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        for name, c in self._counters.items():
            out[name] = c.value
        for name, g in self._gauges.items():
            out[name] = g.value
        for name, h in self._histograms.items():
            out[name] = h.snapshot()
        return out


# ---------------------------------------------------------------------------------
# request lifecycle tracing
# ---------------------------------------------------------------------------------
SCHED_TRACK = -1  # tid 0 in the export; slot s exports as tid s + 1


@dataclasses.dataclass(frozen=True)
class TraceEvent:
    """One lifecycle event. ``track`` is a batch slot id or SCHED_TRACK; ``ph``
    is the Chrome phase ("B"/"E" duration pair, "i" instant)."""

    ts_us: float
    ph: str
    name: str
    track: int
    args: Optional[Dict[str, Any]] = None


class EngineTrace:
    """Bounded ring buffer of engine lifecycle events.

    All emission is host-side appends of already-host-resident scalars — no
    device sync, no per-token work. The buffer is a ``deque(maxlen=capacity)``:
    a long run wraps instead of growing, and ``to_chrome`` repairs the
    truncated track prefixes/suffixes so the export is always schema-valid.
    """

    def __init__(self, capacity: int = 65536):
        self.capacity = capacity
        self._events: deque = deque(maxlen=capacity)
        self._t0 = time.perf_counter()
        self.dropped = 0

    # -- emission (the engine-facing API) -----------------------------------------
    def _ts(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6  # Chrome ts is in us

    def _push(self, ev: TraceEvent) -> None:
        if len(self._events) == self.capacity:
            self.dropped += 1
        self._events.append(ev)

    def instant(self, name: str, track: int = SCHED_TRACK, **args) -> None:
        self._push(TraceEvent(self._ts(), "i", name, track, args or None))

    def begin(self, name: str, track: int, **args) -> None:
        self._push(TraceEvent(self._ts(), "B", name, track, args or None))

    def end(self, name: str, track: int, **args) -> None:
        self._push(TraceEvent(self._ts(), "E", name, track, args or None))

    def clear(self) -> None:
        self._events.clear()
        self.dropped = 0
        self._t0 = time.perf_counter()

    # -- inspection (tests treat this as the host-side log) ------------------------
    @property
    def events(self) -> List[TraceEvent]:
        return list(self._events)

    def count(self, name: str, ph: Optional[str] = None) -> int:
        return sum(
            1 for e in self._events
            if e.name == name and (ph is None or e.ph == ph)
        )

    def __len__(self) -> int:
        return len(self._events)

    # -- export --------------------------------------------------------------------
    def to_chrome(self, pid: int = 1) -> Dict[str, Any]:
        """Chrome trace-event JSON: one track (tid) per batch slot + a
        scheduler track, with thread-name metadata so Perfetto labels them.
        Ring-buffer wraps can orphan B/E pairs at the edges; the export drops
        unmatched "E"s and closes unmatched "B"s at the final timestamp, so
        the result always passes ``validate_chrome_trace``."""
        events = sorted(self._events, key=lambda e: e.ts_us)
        out: List[Dict[str, Any]] = []
        tracks = sorted({e.track for e in events})
        for track in tracks:
            tid = 0 if track == SCHED_TRACK else track + 1
            name = "scheduler" if track == SCHED_TRACK else f"slot {track}"
            out.append({
                "ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
                "ts": 0, "args": {"name": name},
            })
        open_stacks: Dict[int, List[Dict[str, Any]]] = {t: [] for t in tracks}
        last_ts = events[-1].ts_us if events else 0.0
        for e in events:
            tid = 0 if e.track == SCHED_TRACK else e.track + 1
            rec: Dict[str, Any] = {
                "ph": e.ph, "name": e.name, "pid": pid, "tid": tid,
                "ts": e.ts_us, "cat": "serving",
            }
            if e.args:
                rec["args"] = e.args
            if e.ph == "i":
                rec["s"] = "t"  # thread-scoped instant
            elif e.ph == "B":
                open_stacks[e.track].append(rec)
            elif e.ph == "E":
                if not open_stacks[e.track]:
                    continue  # wrap orphan: the matching B fell off the ring
                open_stacks[e.track].pop()
            out.append(rec)
        for track, stack in open_stacks.items():
            tid = 0 if track == SCHED_TRACK else track + 1
            for rec in reversed(stack):
                out.append({
                    "ph": "E", "name": rec["name"], "pid": pid, "tid": tid,
                    "ts": last_ts, "cat": "serving",
                })
        return {"traceEvents": out, "displayTimeUnit": "ms"}

    def export(self, path) -> None:
        from pathlib import Path

        Path(path).write_text(json.dumps(self.to_chrome()))


def validate_chrome_trace(trace: Dict[str, Any]) -> None:
    """Schema-check an exported trace; raises ValueError on the first defect.

    Checks (what CI and the tests gate on):
      * top level is {"traceEvents": [...]} with every event a dict carrying
        ph/pid/tid/name, and ts for non-metadata phases;
      * timestamps are non-decreasing (the exporter sorts; Perfetto tolerates
        unsorted input, our schema does not);
      * per (pid, tid) track, "B" and "E" duration events pair up under stack
        discipline with matching names, and no track ends with an open "B".
    """
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = trace["traceEvents"]
    if not isinstance(events, list):
        raise ValueError("traceEvents must be a list")
    last_ts = None
    stacks: Dict[Tuple[int, int], List[str]] = {}
    for i, e in enumerate(events):
        if not isinstance(e, dict):
            raise ValueError(f"event {i} is not a dict")
        for key in ("ph", "pid", "tid", "name"):
            if key not in e:
                raise ValueError(f"event {i} missing required key {key!r}")
        ph = e["ph"]
        if ph == "M":
            continue
        if "ts" not in e:
            raise ValueError(f"event {i} ({e['name']!r}) missing ts")
        ts = e["ts"]
        if last_ts is not None and ts < last_ts:
            raise ValueError(
                f"event {i} ({e['name']!r}): ts {ts} < previous {last_ts} — "
                "trace not sorted"
            )
        last_ts = ts
        track = (e["pid"], e["tid"])
        stack = stacks.setdefault(track, [])
        if ph == "B":
            stack.append(e["name"])
        elif ph == "E":
            if not stack:
                raise ValueError(
                    f"event {i}: 'E' for {e['name']!r} on track {track} "
                    "with no open 'B'"
                )
            opened = stack.pop()
            if opened != e["name"]:
                raise ValueError(
                    f"event {i}: 'E' for {e['name']!r} closes open "
                    f"'B' {opened!r} on track {track}"
                )
        elif ph not in ("i", "I", "C"):
            raise ValueError(f"event {i}: unknown phase {ph!r}")
    for track, stack in stacks.items():
        if stack:
            raise ValueError(f"track {track} ends with open 'B' events: {stack}")
