"""The mdspan core of the port: so far only what quantized serving weights
need (``QuantizedAccessor`` and the batched ``quantize_array`` /
``dequantize_array``). Extents, layouts (``LayoutPaged`` included), mdspan,
submdspan and the other accessors wait for ROADMAP Queue 1 item 3."""
from .accessors import QuantizedAccessor
from .distributed import dequantize_array, quantize_array

__all__ = ["QuantizedAccessor", "dequantize_array", "quantize_array"]
