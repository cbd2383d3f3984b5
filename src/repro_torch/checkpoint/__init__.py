"""The port's checkpoint store (``repro.checkpoint``)."""
from .store import CheckpointManager, latest_step, restore, save

__all__ = ["CheckpointManager", "latest_step", "restore", "save"]
