"""Accessors of the port: the element-representation customization point.

Port of the part of ``repro.core.accessors.QuantizedAccessor`` that quantized
serving weights use: the policy record (logical element type, bits, block)
and its ``qmax``. Its flat-buffer access/store methods wait with the rest of
``core`` (ROADMAP Queue 1 item 3).
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class QuantizedAccessor:
    """intN storage with one f32 scale per block of ``block`` consecutive
    elements along the last dim; int4 packs two values per int8 byte
    (adjacent pairs: byte j holds value 2j in the lo nibble, 2j + 1 in the
    hi)."""

    element_type: torch.dtype = torch.float32
    bits: int = 8
    block: int = 64

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError("QuantizedAccessor supports bits in {4, 8}")

    @property
    def qmax(self) -> int:
        return 7 if self.bits == 4 else 127
