"""Step-time straggler detection for the serving loop (the port's copy of
``repro.runtime.health.StragglerPolicy``; host-only Python)."""
from __future__ import annotations

import dataclasses
from typing import Optional


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
