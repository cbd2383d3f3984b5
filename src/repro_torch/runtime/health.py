"""Fault-tolerance primitives, host-only Python (the port's copy of
``repro.runtime.health``): heartbeats, step-time straggler detection, and
failure injection for tests and the card's trainer-loop run."""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional


@dataclasses.dataclass
class HeartbeatMonitor:
    """Tracks per-host liveness; declares a host dead after ``timeout_s``
    of silence."""

    num_hosts: int
    timeout_s: float = 60.0
    clock: Callable[[], float] = time.monotonic

    def __post_init__(self):
        now = self.clock()
        self.last_seen: Dict[int, float] = {h: now for h in range(self.num_hosts)}

    def beat(self, host: int, at: Optional[float] = None):
        self.last_seen[host] = self.clock() if at is None else at

    def dead_hosts(self, at: Optional[float] = None) -> List[int]:
        now = self.clock() if at is None else at
        return [h for h, t in self.last_seen.items() if now - t > self.timeout_s]

    def all_alive(self) -> bool:
        return not self.dead_hosts()


@dataclasses.dataclass
class StragglerPolicy:
    """Keeps an EMA of step wall-time; a step slower than ``threshold``x the
    EMA is 'straggle', and ``patience`` consecutive straggles return
    'rebalance'. Outliers never enter the EMA."""

    threshold: float = 2.0
    patience: int = 3
    ema_decay: float = 0.9

    def __post_init__(self):
        self.ema: Optional[float] = None
        self.strikes = 0

    def observe(self, step_time_s: float) -> str:
        if self.ema is None:
            self.ema = step_time_s
            return "ok"
        slow = step_time_s > self.threshold * self.ema
        if not slow:
            self.ema = self.ema_decay * self.ema + (1 - self.ema_decay) * step_time_s
            self.strikes = 0
            return "ok"
        self.strikes += 1
        if self.strikes >= self.patience:
            self.strikes = 0
            return "rebalance"
        return "straggle"


class simulate_failure:
    """Failure injection: ``maybe_fail(step)`` raises the given exception at
    ``at_step``."""

    def __init__(self, at_step: int, exc: Optional[Exception] = None):
        self.at_step = at_step
        self.exc = exc or RuntimeError("simulated node failure")

    def maybe_fail(self, step: int):
        if step == self.at_step:
            raise self.exc
