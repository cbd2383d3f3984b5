"""LR schedules: callables of the int32 step tensor giving an f32 tensor on
its device (the reference's ``repro.optim.schedules``)."""
from __future__ import annotations

import math

import torch


def constant(lr: float):
    def f(step):
        return torch.tensor(lr, dtype=torch.float32, device=_device(step))

    return f


def warmup_cosine(peak: float, warmup_steps: int, total_steps: int, floor: float = 0.0):
    """peak * s / warmup below ``warmup_steps``, then a cosine from ``peak`` to
    ``floor`` over the remaining steps, all in f32."""
    def f(step):
        s = torch.as_tensor(step, device=_device(step)).float()
        warm = peak * s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = floor + 0.5 * (peak - floor) * (1 + torch.cos(math.pi * prog))
        return torch.where(s < warmup_steps, warm, cos)

    return f


def _device(step):
    return step.device if isinstance(step, torch.Tensor) else None
