"""repro_torch.core — the paper's contribution: mdspan (extents × layout ×
accessor) in PyTorch, the port of ``repro.core``.

Exports the reference's ``__all__`` name for name, plus the batched
``quantize_array`` / ``dequantize_array`` of quantized serving weights and
the distribution layer of ``core.distributed``: ``DistributedLayout``,
``ShardingRules`` (logical axes -> mesh axes -> DTensor placements) and the
``tree_*`` helpers. The layout's type selects the kernel schedule in
``repro_torch.kernels.ops`` (``sum3d`` / ``matvec`` on an ``MdSpan``). The
spec class is ``models.layers.ParamSpec``, the reference's TensorSpec.
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
from .distributed import (
    DistributedLayout,
    ShardingRules,
    dequantize_array,
    quantize_array,
    tree_distribute,
    tree_param_bytes,
    tree_param_count,
    tree_shardings,
)

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
    "DistributedLayout",
    "ShardingRules",
    "tree_distribute",
    "tree_param_bytes",
    "tree_param_count",
    "tree_shardings",
]
