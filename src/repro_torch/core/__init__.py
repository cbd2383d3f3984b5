"""repro_torch.core — the paper's contribution: mdspan (extents × layout ×
accessor) in PyTorch, the port of ``repro.core``.

Exports the reference's ``__all__`` name for name, plus the batched
``quantize_array`` / ``dequantize_array`` of quantized serving weights. The
layout's type selects the kernel schedule in ``repro_torch.kernels.ops``
(``sum3d`` / ``matvec`` on an ``MdSpan``). Not ported yet: the reference's
``core.distributed`` sharding rules and TensorSpec (ROADMAP Queue 1 item 6).
"""
from .extents import Extents, dynamic_extent
from .layouts import (
    LayoutError,
    LayoutLeft,
    LayoutMapping,
    LayoutPaged,
    LayoutRight,
    LayoutStride,
    LayoutSymmetricPacked,
    LayoutTiledTPU,
)
from .accessors import (
    Accessor,
    AccumulateAccessor,
    BasicAccessor,
    BitPackedAccessor,
    HostTierAccessor,
    MemorySpace,
    MemorySpaceAccessor,
    QuantizedAccessor,
    RestrictAccessor,
    require_same_space,
)
from .mdspan import MdSpan, mdspan
from .submdspan import SliceShape, all_, submdspan
from . import algorithms
from .distributed import dequantize_array, quantize_array

__all__ = [
    "Extents",
    "dynamic_extent",
    "LayoutError",
    "LayoutLeft",
    "LayoutMapping",
    "LayoutPaged",
    "LayoutRight",
    "LayoutStride",
    "LayoutSymmetricPacked",
    "LayoutTiledTPU",
    "Accessor",
    "AccumulateAccessor",
    "BasicAccessor",
    "BitPackedAccessor",
    "HostTierAccessor",
    "MemorySpace",
    "MemorySpaceAccessor",
    "QuantizedAccessor",
    "RestrictAccessor",
    "require_same_space",
    "MdSpan",
    "mdspan",
    "SliceShape",
    "all_",
    "submdspan",
    "algorithms",
    "dequantize_array",
    "quantize_array",
]
