"""Blocked quantization of whole arrays: the port of
``repro.core.distributed.quantize_array`` / ``dequantize_array``, and the
int4 nibble packers every quantized representation of the port shares
(adjacent pairs for weights and ``QuantizedAccessor``, split-half for KV
pages and ``Int4SplitHalfAccessor``). The reference module's sharding rules
and TensorSpec wait for ROADMAP Queue 1 item 6 (distribution)."""
from __future__ import annotations

from typing import TYPE_CHECKING, Dict

import torch

if TYPE_CHECKING:
    from .accessors import QuantizedAccessor


def as_int8_bits(v: torch.Tensor) -> torch.Tensor:
    """Integer values in [0, 256) as the int8 with the same bit pattern."""
    v = v.to(torch.int16) & 0xFF
    return (v - ((v & 0x80) << 1)).to(torch.int8)


def signed_nibble(v: torch.Tensor) -> torch.Tensor:
    """Sign-extend 4-bit values in [0, 16) to int8 in [-8, 8)."""
    v = v.to(torch.int8)
    return torch.where(v >= 8, v - 16, v)


def pack_int4_adjacent(q: torch.Tensor) -> torch.Tensor:
    """Signed int4 values (last dim even) two per byte, adjacent pairs: byte j
    holds value 2j in the lo nibble and value 2j + 1 in the hi nibble."""
    q2 = q.reshape(*q.shape[:-1], q.shape[-1] // 2, 2).to(torch.int16)
    return as_int8_bits((q2[..., 0] & 0x0F) | ((q2[..., 1] & 0x0F) << 4))


def unpack_int4_adjacent(b: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4_adjacent: (..., K/2) bytes -> (..., K) int8."""
    lo = signed_nibble(b & 0x0F)
    hi = signed_nibble((b >> 4) & 0x0F)
    return torch.stack([lo, hi], dim=-1).reshape(*b.shape[:-1], b.shape[-1] * 2)


def pack_int4_splithalf(q: torch.Tensor) -> torch.Tensor:
    """Signed int4 values (last dim D even) two per byte, split-half: byte d
    holds value d in the lo nibble and value d + D/2 in the hi nibble, so a
    token's K/V row maps to whole bytes of its own (the KV pages' order)."""
    d = q.shape[-1]
    q = q.to(torch.int16)
    return as_int8_bits((q[..., :d // 2] & 0x0F) | ((q[..., d // 2:] & 0x0F) << 4))


def unpack_int4_splithalf(b: torch.Tensor) -> torch.Tensor:
    """Inverse of pack_int4_splithalf, sign-extending each nibble."""
    return torch.cat([signed_nibble(b & 0x0F), signed_nibble((b >> 4) & 0x0F)], dim=-1)


def quantize_array(dense: torch.Tensor, acc: QuantizedAccessor) -> Dict[str, torch.Tensor]:
    """Quantize along the LAST dim in blocks of ``acc.block``: {"q": int8
    (..., last) or, for int4, (..., last / 2), "scale": f32 (..., last /
    block)}. Each block's scale is absmax / qmax (1.0 for an all-zero block);
    values are x / scale rounded half to even and clipped to +-qmax, the
    reference's arithmetic step for step, so bytes and scales are bit-equal
    to its on the same f32 input."""
    *lead, last = dense.shape
    if last % acc.block != 0:
        raise ValueError(f"last dim {last} % block {acc.block} != 0")
    nb = last // acc.block
    x = dense.float().reshape(*lead, nb, acc.block)
    absmax = x.abs().amax(dim=-1)
    scale = torch.where(absmax > 0, absmax / acc.qmax, torch.ones_like(absmax))
    q = torch.clamp(torch.round(x / scale[..., None]), -acc.qmax, acc.qmax).to(torch.int8)
    q = q.reshape(*lead, last)
    if acc.bits == 4:
        q = pack_int4_adjacent(q)
    return {"q": q, "scale": scale}


def dequantize_array(bufs: Dict[str, torch.Tensor], acc: QuantizedAccessor) -> torch.Tensor:
    """Inverse of quantize_array (up to quantization error), in
    ``acc.element_type``."""
    q, scale = bufs["q"], bufs["scale"]
    if acc.bits == 4:
        q = unpack_int4_adjacent(q)
    *lead, last = q.shape
    nb = scale.shape[-1]
    x = q.float().reshape(*lead, nb, last // nb) * scale[..., None]
    return x.reshape(*lead, last).to(acc.element_type)
