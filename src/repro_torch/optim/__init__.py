"""The port's optimizer: AdamW with optional int8 moments, and LR schedules
(``repro.optim``)."""
from .adamw import (
    AdamWConfig,
    MomentSpec,
    adamw_init,
    adamw_init_specs,
    adamw_update,
    clip_by_global_norm,
)
from .schedules import constant, warmup_cosine

__all__ = [
    "AdamWConfig",
    "MomentSpec",
    "adamw_init",
    "adamw_init_specs",
    "adamw_update",
    "clip_by_global_norm",
    "constant",
    "warmup_cosine",
]
