"""PagedQuantSpec: block scales of the quantized accessor composed with the
paged KV layout.

Port of ``repro.serving.engine.kvquant``. The paged pool keeps its layout
(block-table indirection, refcounts, prefix index, CoW) and swaps its element
representation: int8 or int4 page bytes with one f32 scale per (physical
page, KV head), decoded on access and encoded on scatter. Because scales are
keyed by physical page, every allocator law carries over unchanged: a shared
quantized page is copied (bytes and scale) and privatized like an f32 one.

int4 pages pack split-half along the feature dim
(``core.distributed.pack_int4_splithalf``: byte d holds feature d in
the lo nibble and d + D/2 in the hi), so a token's scatter stays within its
own bytes; quantized weights pack adjacent pairs instead.

Scale lifecycle (deterministic, so prefix sharing dedupes quantized pages):
  - prefill and chunk scatter: a fresh scale per (page, head) from the page's
    own absmax (zero-padded slack included);
  - decode append at slot 0: the page is brand new, so a fresh scale from the
    token itself;
  - decode append at slot > 0: re-quantize with the page's EXISTING scale,
    clipped.

``as_flat_accessor`` names the equivalent flat accessor over the paged
codomain (``core.QuantizedAccessor`` for int8, ``Int4SplitHalfAccessor`` for
int4), which makes a quantized pool observable through
``core.instrument.CountingAccessor``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch.core.accessors import Int4SplitHalfAccessor, QuantizedAccessor
from repro_torch.core.distributed import pack_int4_splithalf
from repro_torch.kernels.paged_attention import dequantize_pages


@dataclasses.dataclass(frozen=True)
class PagedQuantSpec:
    """Element-representation policy for a paged KV pool. A quantized pool
    leaf is {"q": int8 (..., num_pages, Hkv, page_size, Dq), "scale": f32
    (..., num_pages, Hkv)}, Dq = D (int8) or D / 2 (int4). Every method is
    polymorphic in the leading dims. Rounding is half to even on x / scale (a
    division, as the reference), so bytes and scales are bit-equal to the
    reference's on the same f32 input."""

    bits: int = 8
    element_type: torch.dtype = torch.float32

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError("PagedQuantSpec supports bits in {4, 8}")

    @property
    def qmax(self) -> int:
        return 7 if self.bits == 4 else 127

    def packed_dim(self, head_dim: int) -> int:
        if self.bits == 8:
            return head_dim
        if head_dim % 2:
            raise ValueError(f"int4 KV pages need an even head_dim, got {head_dim}")
        return head_dim // 2

    def _scale(self, absmax: torch.Tensor) -> torch.Tensor:
        return torch.where(absmax > 0, absmax / self.qmax, torch.ones_like(absmax))

    def _pack(self, q: torch.Tensor) -> torch.Tensor:
        q = q.to(torch.int8)
        return pack_int4_splithalf(q) if self.bits == 4 else q

    def encode_pages(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        """x (..., page_size, D) -> {"q": (..., page_size, Dq), "scale": (...)},
        one fresh scale per (page, head) slice (1.0 for an all-zero one)."""
        x = x.float()
        scale = self._scale(x.abs().amax(dim=(-2, -1)))
        q = torch.clamp(torch.round(x / scale[..., None, None]), -self.qmax, self.qmax)
        return {"q": self._pack(q), "scale": scale}

    def decode_pages(self, q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """Inverse of encode_pages (up to quantization error)."""
        return dequantize_pages(q, scale, bits=self.bits).to(self.element_type)

    def token_scale(self, tok: torch.Tensor) -> torch.Tensor:
        """Fresh scale for a page whose first content is this token: (..., D)
        -> (...)."""
        return self._scale(tok.float().abs().amax(dim=-1))

    def quantize_tokens(self, tok: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        """Quantize token vectors (..., D) with a GIVEN (page, head) scale
        (...), clipped: packed (..., Dq) int8."""
        safe = torch.where(scale > 0, scale, torch.ones_like(scale))
        q = torch.clamp(torch.round(tok.float() / safe[..., None]), -self.qmax, self.qmax)
        return self._pack(q)

    def as_flat_accessor(self, page_size: int, head_dim: int) -> QuantizedAccessor:
        """The equivalent flat accessor over the LayoutPaged codomain:
        (page, head) scales == block scales with block = page_size * head_dim.

        int8 returns a plain ``QuantizedAccessor`` (the pool's flat bytes ARE
        its buffers). int4 returns ``Int4SplitHalfAccessor`` with
        row = head_dim, the accessor that speaks the pages' split-half nibble
        order (the packed pool reshaped to 1-D is byte-identical to its
        encoding)."""
        if self.bits == 8:
            return QuantizedAccessor(self.element_type, bits=8, block=page_size * head_dim)
        return Int4SplitHalfAccessor(
            self.element_type, bits=4, block=page_size * head_dim, row=head_dim
        )


# kv_dtype config values -> element representation (None: dense pages in the
# model's dtype)
KV_DTYPES: Dict[str, Optional[PagedQuantSpec]] = {
    "f32": None,
    "int8": PagedQuantSpec(bits=8),
    "int4": PagedQuantSpec(bits=4),
}


def pool_leaves(tree):
    """Every tensor of a (possibly quantized) page pool, or a list of them."""
    if isinstance(tree, dict):
        for v in tree.values():
            yield from pool_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from pool_leaves(v)
    else:
        yield tree


def kv_pool_bytes(pools) -> int:
    """Device bytes held by a (possibly quantized) list of page-pool dicts."""
    return int(sum(t.numel() * t.element_size() for t in pool_leaves(pools)))
