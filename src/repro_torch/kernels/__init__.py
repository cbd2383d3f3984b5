"""Hand-written CUDA kernels for Hopper (sm_90a) + their plain PyTorch versions.

Layout: ``csrc/*.cu`` (plain C interface, built by ``_build.py`` with nvcc at
first use and loaded through ctypes), one Python module per kernel family
holding the wrappers and the plain versions, and ``ops.py`` as the dispatching
API. Importing builds nothing. Each wrapper counts its kernel's launches in
``.launches``; ``launch_counts()`` reads them all.
"""
from typing import Dict

from . import (
    flash_attention,
    flash_vjp,
    matvec,
    ops,
    paged_attention,
    quant_matmul,
    rglru_scan,
    ssd_scan,
    stencil3d,
    sum3d,
    tinymatsum,
)

KERNEL_WRAPPERS = {
    **paged_attention.KERNEL_WRAPPERS,
    **flash_attention.KERNEL_WRAPPERS,
    **flash_vjp.KERNEL_WRAPPERS,
    **ssd_scan.KERNEL_WRAPPERS,
    **rglru_scan.KERNEL_WRAPPERS,
    **quant_matmul.KERNEL_WRAPPERS,
    **sum3d.KERNEL_WRAPPERS,
    **stencil3d.KERNEL_WRAPPERS,
    **tinymatsum.KERNEL_WRAPPERS,
    **matvec.KERNEL_WRAPPERS,
}


def launch_counts() -> Dict[str, int]:
    """Kernel name -> launches since the last reset."""
    return {name: fn.launches for name, fn in KERNEL_WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in KERNEL_WRAPPERS.values():
        fn.launches = 0


__all__ = ["KERNEL_WRAPPERS", "launch_counts", "ops", "reset_launch_counts"]
