"""The device policy shared by the port's entry points: CUDA unless the caller
names a device. ``kernels.common`` re-exports it."""
from __future__ import annotations

from typing import Optional, Union

import torch


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names one.

    With no GPU and no explicit device this raises; nothing falls back to the
    CPU quietly. Pass ``device="cpu"`` to run the plain PyTorch versions."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on CUDA by default and no GPU is available; "
                "pass device='cpu' to run the plain PyTorch versions on the CPU"
            )
        return torch.device("cuda")
    return torch.device(device)
