"""The port's runtime: the trainer loop and its fault-tolerance primitives
(``repro.runtime``)."""
from .health import HeartbeatMonitor, StragglerPolicy, simulate_failure
from .loop import RunConfig, TrainerLoop

__all__ = [
    "HeartbeatMonitor",
    "RunConfig",
    "StragglerPolicy",
    "TrainerLoop",
    "simulate_failure",
]
