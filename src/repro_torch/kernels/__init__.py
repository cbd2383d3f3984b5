"""Hand-written CUDA kernels for Hopper (sm_90a) + their plain PyTorch versions.

Layout: ``csrc/*.cu`` (plain C interface, built by ``_build.py`` with nvcc at
first use and loaded through ctypes), one Python module per kernel family
holding the wrappers and the plain versions, and ``ops.py`` as the dispatching
API. Importing builds nothing.
"""
from . import ops

__all__ = ["ops"]
