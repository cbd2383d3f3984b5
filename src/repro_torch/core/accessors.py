"""Accessors: the paper's Table II concept, functionally restated for PyTorch.

Port of ``repro.core.accessors``, with the reference's functional contract:

C++ signature                      restatement
--------------------------------   ---------------------------------------------------
A::pointer                         a tensor, or a dict of tensors (main storage +
                                   auxiliaries, e.g. quantization scales)
A::reference (lvalue)              a get/set pair:
a.access(p, i) -> reference          access(buffers, i) -> value  (read)
                                     store(buffers, i, v) -> NEW buffers; the
                                     input buffers are never written
a.offset(p, i) -> pointer          offset(buffers, i) -> buffers rebased at i
A::offset_policy                   offset_policy property (type of the rebased view)
decay to ordinary pointer          decay(buffers) -> plain codomain tensor

Accessors implemented:
  BasicAccessor        the default (std::accessor_basic); identity access
  RestrictAccessor     identity, kept for API parity with the paper's Fig. 1
  AccumulateAccessor   stores ACCUMULATE (index_put with accumulate), the analogue
                       of the paper's AtomicAccessor; safe on NON-unique layouts
  BitPackedAccessor    bools packed 8-per-byte (the vector<bool> use case)
  QuantizedAccessor    intN storage + per-block scales, dequantize on access;
                       backs int8 serving weights (core.distributed)
  Int4SplitHalfAccessor  int4 in the KV pages' split-half nibble order, so a
                       quantized int4 pool is a flat accessor too
  MemorySpaceAccessor  strong memory-space types (the paper's "strong pointer
                       types for heterogeneous memory"), checked by
                       ``require_same_space``
  HostTierAccessor     TWO-space composition: any element accessor over an
                       {hbm, host} buffer pair, offsets routed by page residency

``i`` may be a Python int or a tensor (or numpy array) of offsets (gather /
scatter semantics), so a whole-domain read costs one gather. Offsets are
FRONT-INDEXED: the packed accessors reject negative static offsets, whose
nibble parity and block scale depend on a span the buffers do not record.

The accessor sees only flat codomain offsets, so any layout can feed it
(paper §customization points): the paged KV pool keeps its index map in
``layouts.LayoutPaged`` while ``serving.engine.kvquant.PagedQuantSpec``
swaps its element representation (``as_flat_accessor`` returns the
equivalent accessor here), and ``core.instrument.CountingAccessor`` wraps
any of them to tally traffic, priced by each accessor's own
``bytes_for_offsets``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Any, Tuple

import numpy as np
import torch

from .device import resolve_device
from .distributed import (
    as_int8_bits,
    pack_int4_adjacent,
    pack_int4_splithalf,
    signed_nibble,
)


def device_of(buffers) -> torch.device:
    """The device of a tensor, or of the first tensor in a dict of buffers."""
    if isinstance(buffers, torch.Tensor):
        return buffers.device
    return device_of(next(iter(buffers.values())))


def as_tensor(x, dtype=None, device=None) -> torch.Tensor:
    """``x`` as a tensor of ``dtype`` (None: keep or infer it). A tensor stays
    on its device unless ``device`` names one; anything else (numpy, Python
    numbers) goes to ``resolve_device(device)``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype) if device is not None else x.to(dtype or x.dtype)
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=resolve_device(device))


def _offsets(i, device):
    """Offsets as an int64 tensor on ``device`` (a scalar becomes 0-d)."""
    if isinstance(i, torch.Tensor):
        return i.to(device=device, dtype=torch.int64)
    return torch.as_tensor(np.asarray(i, dtype=np.int64), device=device)


def _host_offsets(i) -> np.ndarray:
    return i.detach().cpu().numpy() if isinstance(i, torch.Tensor) else np.asarray(i)


def _set(buf: torch.Tensor, i, value) -> torch.Tensor:
    """A copy of ``buf`` with ``buf[i] = value`` (the functional scatter)."""
    out = buf.clone()
    out[_offsets(i, buf.device)] = as_tensor(value, buf.dtype, buf.device)
    return out


class Accessor:
    """Base documenting the concept; see module docstring."""

    element_type: Any  # logical dtype exposed to algorithms

    # storage ------------------------------------------------------------------
    def storage_dtype(self):
        return self.element_type

    def alloc(self, span_size: int, device=None):
        """Allocate zeroed buffers for a codomain of ``span_size`` elements."""
        raise NotImplementedError

    def from_codomain(self, dense_codomain, device=None):
        """Encode a plain codomain array (element_type) into buffers."""
        raise NotImplementedError

    # access -------------------------------------------------------------------
    def access(self, buffers, i):
        raise NotImplementedError

    def store(self, buffers, i, value):
        raise NotImplementedError

    def decay(self, buffers):
        """Plain tensor over the codomain (C++: decay to ordinary pointer)."""
        raise NotImplementedError

    @property
    def offset_policy(self) -> "Accessor":
        return self

    def offset(self, buffers, i):
        """Rebase buffers at offset i (C++ a.offset(p, i)); returns buffers usable
        with ``self.offset_policy`` such that access(offset(p,i), 0) == access(p,i)."""
        raise NotImplementedError

    # instrumentation ----------------------------------------------------------
    def bytes_for_offsets(self, i) -> int:
        """Storage bytes behind a batch of offsets ``i`` (scalar or array) —
        the representation-specific cost model ``core.instrument``'s
        CountingAccessor charges per access/store. Dense default: one storage
        element per offset."""
        return int(np.size(_host_offsets(i))) * self.storage_dtype().itemsize


@dataclasses.dataclass(frozen=True)
class BasicAccessor(Accessor):
    element_type: Any = torch.float32

    def alloc(self, span_size: int, device=None):
        return torch.zeros((span_size,), dtype=self.element_type, device=resolve_device(device))

    def from_codomain(self, dense, device=None):
        return as_tensor(dense, self.element_type, device)

    def access(self, buffers, i):
        return buffers[_offsets(i, buffers.device)]

    def store(self, buffers, i, value):
        return _set(buffers, i, value)

    def decay(self, buffers):
        return buffers

    def offset(self, buffers, i):
        return buffers[i:]


@dataclasses.dataclass(frozen=True)
class RestrictAccessor(BasicAccessor):
    """Paper Fig. 1. Functional stores leave nothing to annotate; this accessor
    keeps the concept surface complete and is the identity."""


@dataclasses.dataclass(frozen=True)
class AccumulateAccessor(Accessor):
    """Stores ACCUMULATE (scatter-add) instead of overwrite.

    The analogue of the paper's AtomicAccessor: the dominant HPC use of atomics
    is concurrent accumulation, expressed here as a sum-combining scatter (well
    defined on unique and non-unique layouts). The linearity law replaces the
    atomicity law: storing v1 then v2 at the same offset yields +v1+v2
    regardless of order.
    """

    element_type: Any = torch.float32

    def alloc(self, span_size: int, device=None):
        return torch.zeros((span_size,), dtype=self.element_type, device=resolve_device(device))

    def from_codomain(self, dense, device=None):
        return as_tensor(dense, self.element_type, device)

    def access(self, buffers, i):
        return buffers[_offsets(i, buffers.device)]

    def store(self, buffers, i, value):
        idx = _offsets(i, buffers.device)
        vals = as_tensor(value, buffers.dtype, buffers.device).expand(idx.shape)
        return buffers.clone().index_put_((idx,), vals, accumulate=True)

    def decay(self, buffers):
        return buffers

    def offset(self, buffers, i):
        return buffers[i:]


_BIT_WEIGHTS = tuple(1 << b for b in range(8))


@dataclasses.dataclass(frozen=True)
class BitPackedAccessor(Accessor):
    """bool elements packed 8-per-uint8 (paper: the std::vector<bool> use case)."""

    element_type: Any = torch.bool

    def storage_dtype(self):
        return torch.uint8

    @staticmethod
    def packed_size(span_size: int) -> int:
        return -(-span_size // 8)

    def alloc(self, span_size: int, device=None):
        return torch.zeros((self.packed_size(span_size),), dtype=torch.uint8,
                           device=resolve_device(device))

    def from_codomain(self, dense, device=None):
        dense = as_tensor(dense, torch.bool, device)
        pad = (-dense.shape[0]) % 8
        bits = torch.cat([dense, dense.new_zeros((pad,))]).reshape(-1, 8)
        weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.int64, device=dense.device)
        return (bits.to(torch.int64) * weights).sum(dim=1).to(torch.uint8)

    @staticmethod
    def _check_offset(i):
        # bit parity of a negative offset depends on the true span, which the
        # byte buffer does not record (see QuantizedAccessor._check_offset)
        if isinstance(i, (int, np.integer)) and i < 0:
            raise TypeError("BitPackedAccessor offsets must be non-negative")

    def access(self, buffers, i):
        self._check_offset(i)
        i = _offsets(i, buffers.device)
        byte = buffers[i // 8].to(torch.int64)
        return ((byte >> (i % 8)) & 1).to(torch.bool)

    def store(self, buffers, i, value):
        self._check_offset(i)
        i = _offsets(i, buffers.device)
        bit = 1 << (i % 8)
        byte_idx = i // 8
        cur = buffers[byte_idx].to(torch.int64)
        # set-or-clear functionally: clear the bit, or OR it back in
        newbyte = torch.where(as_tensor(value, torch.bool, buffers.device), cur | bit, cur & ~bit)
        out = buffers.clone()
        out[byte_idx] = newbyte.to(torch.uint8)
        return out

    def decay(self, buffers):
        weights = torch.tensor(_BIT_WEIGHTS, dtype=torch.uint8, device=buffers.device)
        return ((buffers[:, None] & weights[None, :]) != 0).reshape(-1)

    def offset(self, buffers, i):
        if isinstance(i, int) and i % 8 == 0:
            return buffers[i // 8:]
        raise TypeError("BitPackedAccessor.offset requires byte-aligned offsets")

    def bytes_for_offsets(self, i) -> int:
        # distinct bytes touched: offsets sharing a byte cost it once
        self._check_offset(i)
        return int(np.unique(_host_offsets(i) // 8).size)


@dataclasses.dataclass(frozen=True)
class QuantizedAccessor(Accessor):
    """intN storage with per-block scales; dequantize on access.

    buffers = {"q": int8[span] (int4: two per byte, adjacent pairs: byte j holds
    value 2j in the lo nibble, 2j + 1 in the hi), "scale": f32[ceil(span/block)]}.
    Each block's scale is absmax / qmax (1.0 for an all-zero block), values
    x / scale rounded half to even and clipped to +-qmax: the reference's
    arithmetic, so bytes and scales are bit-equal to its on the same f32
    input. ``core.distributed.quantize_array`` applies the same policy to the
    last dim of a batch of rows (quantized serving weights).

    ``store`` re-quantizes with the EXISTING block scale (clipped): scales are
    data statistics computed at encode time; a scattered functional write
    cannot cheaply recompute them (``requantize`` does, over the whole span).
    """

    element_type: Any = torch.float32
    bits: int = 8
    block: int = 64

    def __post_init__(self):
        if self.bits not in (4, 8):
            raise ValueError("QuantizedAccessor supports bits in {4, 8}")

    def storage_dtype(self):
        return torch.int8

    @property
    def qmax(self) -> int:
        return 7 if self.bits == 4 else 127

    def _nblocks(self, span: int) -> int:
        return -(-span // self.block)

    def _scales(self, blocked: torch.Tensor) -> torch.Tensor:
        absmax = blocked.abs().amax(dim=1)
        return torch.where(absmax > 0, absmax / self.qmax, torch.ones_like(absmax))

    def _quantize(self, x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
        return torch.clamp(torch.round(x / s), -self.qmax, self.qmax).to(torch.int8)

    def alloc(self, span_size: int, device=None):
        device = resolve_device(device)
        qlen = span_size if self.bits == 8 else -(-span_size // 2)
        return {
            "q": torch.zeros((qlen,), dtype=torch.int8, device=device),
            "scale": torch.ones((self._nblocks(span_size),), dtype=torch.float32, device=device),
        }

    def from_codomain(self, dense, device=None):
        dense = as_tensor(dense, torch.float32, device)
        span = dense.shape[0]
        nb = self._nblocks(span)
        padded = torch.cat([dense, dense.new_zeros((nb * self.block - span,))]).reshape(
            nb, self.block)
        scale = self._scales(padded)
        q = self._quantize(padded, scale[:, None]).reshape(-1)[:span]
        if self.bits == 4:
            q = pack_int4_adjacent(torch.cat([q, q.new_zeros((span % 2,))]))
        return {"q": q, "scale": scale}

    @staticmethod
    def _check_offset(i):
        """Packed storage is front-indexed: a negative offset's byte/nibble
        parity and block-scale index depend on the TRUE span, which the buffers
        do not record (an odd span leaves a pad nibble; a partial last block
        shifts every block boundary)."""
        if isinstance(i, (int, np.integer)) and i < 0:
            raise TypeError(
                "QuantizedAccessor offsets must be non-negative: negative "
                "offsets are ambiguous for block-scaled/nibble-packed storage "
                "(the true span is not recoverable from the buffers)"
            )

    def _byte_and_hi(self, i: torch.Tensor):
        """The byte holding offset ``i`` and whether it is the hi nibble."""
        return i // 2, i % 2 == 1

    def _load_q(self, buffers, i: torch.Tensor) -> torch.Tensor:
        if self.bits == 8:
            return buffers["q"][i]
        byte_idx, hi = self._byte_and_hi(i)
        byte = buffers["q"][byte_idx]
        return signed_nibble(torch.where(hi, (byte >> 4) & 0x0F, byte & 0x0F))

    def access(self, buffers, i):
        self._check_offset(i)
        i = _offsets(i, buffers["q"].device)
        s = buffers["scale"][i // self.block]
        return (self._load_q(buffers, i).float() * s).to(self.element_type)

    def store(self, buffers, i, value):
        self._check_offset(i)
        i = _offsets(i, buffers["q"].device)
        s = buffers["scale"][i // self.block]
        q = self._quantize(as_tensor(value, torch.float32, s.device), s)
        if self.bits == 8:
            return {**buffers, "q": _set(buffers["q"], i, q)}
        byte_idx, hi = self._byte_and_hi(i)
        old = buffers["q"][byte_idx].to(torch.int16)
        qn = q.to(torch.int16) & 0x0F
        new = as_int8_bits(torch.where(hi, (old & 0x0F) | (qn << 4), (old & ~0x0F) | qn))
        return {**buffers, "q": _set(buffers["q"], byte_idx, new)}

    def span_of(self, buffers) -> int:
        n = buffers["q"].shape[0]
        return n if self.bits == 8 else n * 2

    def decay(self, buffers, span=None):
        span = self.span_of(buffers) if span is None else span
        return self.access(buffers, torch.arange(span, device=buffers["q"].device))

    def offset(self, buffers, i):
        if isinstance(i, int) and i % self.block == 0 and (self.bits == 8 or i % 2 == 0):
            qi = i if self.bits == 8 else i // 2
            return {
                "q": buffers["q"][qi:],
                "scale": buffers["scale"][i // self.block:],
            }
        raise TypeError("QuantizedAccessor.offset requires block-aligned offsets")

    def requantize(self, buffers, span=None):
        """Recompute block scales from current contents (periodic optimizer rescale)."""
        return self.from_codomain(self.decay(buffers, span))

    def bytes_for_offsets(self, i) -> int:
        """intN payload bytes + one f32 scale per DISTINCT block touched —
        the bandwidth a quantized gather actually moves (block scales are
        reused across the offsets inside a block)."""
        self._check_offset(i)
        arr = _host_offsets(i)
        payload = int(arr.size) if self.bits == 8 else int(np.unique(arr // 2).size)
        return payload + int(np.unique(arr // self.block).size) * 4


@dataclasses.dataclass(frozen=True)
class Int4SplitHalfAccessor(QuantizedAccessor):
    """int4 storage packed SPLIT-HALF per fixed-width row (the KV-page order).

    ``QuantizedAccessor`` at 4 bits packs ADJACENT offset pairs into a byte;
    quantized KV pages pack each width-``row`` span (a token's head vector)
    with byte ``b`` holding element ``b`` in the lo nibble and element
    ``b + row/2`` in the hi nibble (``core.distributed.pack_int4_splithalf``,
    the order the paged kernels read). This accessor speaks that byte layout
    over the flat codomain, so ``kvquant.PagedQuantSpec.as_flat_accessor``
    returns a real accessor for int4 pools: element offset ``o`` lives at byte
    ``(o // row) * row/2 + (o % row) % (row/2)``, hi nibble iff
    ``o % row >= row/2``. The scale algebra is inherited (``block`` must
    cover whole rows).
    """

    row: int = 2  # split-half span width; head_dim for KV pages

    def __post_init__(self):
        if self.bits != 4:
            raise ValueError("Int4SplitHalfAccessor is the 4-bit packing")
        if self.row % 2:
            raise ValueError("split-half packing needs an even row width")
        if self.block % self.row:
            raise ValueError(
                f"block {self.block} must cover whole rows of {self.row} "
                "(a block scale may not split a packed row)"
            )

    def _byte_and_hi(self, i):
        half = self.row // 2
        d = i % self.row
        return (i // self.row) * half + d % half, d >= half

    def alloc(self, span_size: int, device=None):
        if span_size % self.row:
            raise ValueError("span must be a whole number of rows")
        device = resolve_device(device)
        return {
            "q": torch.zeros((span_size // 2,), dtype=torch.int8, device=device),
            "scale": torch.ones((self._nblocks(span_size),), dtype=torch.float32, device=device),
        }

    def from_codomain(self, dense, device=None):
        dense = as_tensor(dense, torch.float32, device)
        span = dense.shape[0]
        if span % self.row:
            raise ValueError("span must be a whole number of rows")
        blocked = dense.reshape(self._nblocks(span), self.block)
        scale = self._scales(blocked)
        q = self._quantize(blocked, scale[:, None])
        return {"q": pack_int4_splithalf(q.reshape(-1, self.row)).reshape(-1), "scale": scale}

    # offset(): inherited — block-aligned i is row-aligned (block % row == 0),
    # and a row-aligned element offset's byte is exactly i // 2 because rows
    # pack contiguously at row/2 bytes each.

    def bytes_for_offsets(self, i) -> int:
        """Distinct PACKED bytes touched (split-half indexing) + one f32 scale
        per distinct block — the adjacent-pair int4 pricing law, with byte
        identity following this accessor's own layout."""
        self._check_offset(i)
        arr = _host_offsets(i)
        half = self.row // 2
        byte = (arr // self.row) * half + (arr % self.row) % half
        return int(np.unique(byte).size) + int(np.unique(arr // self.block).size) * 4


class MemorySpace(enum.Enum):
    """Strong memory-space types (paper: strong pointer types for heterogeneous
    memory), the reference's names: ANY, HBM (device memory), VMEM and SMEM
    (the TPU's vector and scalar on-chip memories), HOST (host RAM)."""

    ANY = "any"
    HBM = "hbm"
    VMEM = "vmem"
    SMEM = "smem"
    HOST = "host"


@dataclasses.dataclass(frozen=True)
class MemorySpaceAccessor(BasicAccessor):
    """BasicAccessor + a strong space tag. Mixing spaces is an error in
    algorithms that require same-space operands — the strong-typing safety
    argument of the paper, enforced by ``require_same_space``."""

    space: MemorySpace = MemorySpace.ANY

    @property
    def offset_policy(self) -> "Accessor":
        # Offsetting can break alignment guarantees tied to a space (paper's
        # over-aligned pointer example): rebased views decay to ANY.
        if self.space == MemorySpace.VMEM:
            return MemorySpaceAccessor(self.element_type, MemorySpace.ANY)
        return self


def require_same_space(*accessors: Accessor) -> None:
    spaces = {
        a.space for a in accessors if isinstance(a, MemorySpaceAccessor)
    } - {MemorySpace.ANY}
    if len(spaces) > 1:
        raise TypeError(f"operands live in incompatible memory spaces: {spaces}")


# -- accessors as memory spaces (the hierarchical-KV customization point) --------
#
# The accessor policy is the paper's hook for HETEROGENEOUS MEMORY: only the
# accessor resolves an offset to storage, so one view type spans device memory
# and host RAM without the layout or the algorithm changing. HostTierAccessor
# wraps ANY element accessor (f32 / int8 / int4 pages keep their representation
# in either space) and routes each offset to an HBM or a host buffer set by
# PAGE residency; LayoutPaged.space_for / space_for_offset report the same
# classification from the layout side.


@dataclasses.dataclass(frozen=True)
class HostTierAccessor(Accessor):
    """Two-space accessor: ``inner`` applied over {"hbm": ..., "host": ...}
    buffer sets, with each offset routed by the page residency set.

    ``page_elems`` is the codomain extent of one physical page
    (n_heads * page_size * d for KV pools); ``host_pages`` names the page ids
    whose storage currently lives in the host tier. Both buffer sets are full
    inner-accessor buffers over the SAME span, so migration is a pure content
    copy plus a residency-set update — no offset changes, no re-encoding."""

    inner: Accessor = dataclasses.field(default_factory=lambda: BasicAccessor())
    page_elems: int = 1
    host_pages: Tuple[int, ...] = ()

    def __post_init__(self):
        if self.page_elems <= 0:
            raise ValueError("page_elems must be positive")
        object.__setattr__(
            self, "host_pages", tuple(sorted({int(p) for p in self.host_pages}))
        )

    @property
    def element_type(self):
        return self.inner.element_type

    def storage_dtype(self):
        return self.inner.storage_dtype()

    def space_for_offset(self, i) -> MemorySpace:
        """The memory space holding offset ``i`` — total over the span."""
        page = int(i) // self.page_elems
        return MemorySpace.HOST if page in set(self.host_pages) else MemorySpace.HBM

    def _route(self, i: torch.Tensor) -> torch.Tensor:
        pages = i // self.page_elems
        if not self.host_pages:
            return torch.zeros_like(pages, dtype=torch.bool)
        host = torch.tensor(self.host_pages, dtype=torch.int64, device=pages.device)
        return torch.isin(pages, host)

    def alloc(self, span_size: int, device=None):
        return {
            "hbm": self.inner.alloc(span_size, device),
            "host": self.inner.alloc(span_size, device),
        }

    def from_codomain(self, dense, device=None):
        """Encode into the HBM set; the host set starts cold (zeroed)."""
        dense = as_tensor(dense, device=device)
        return {
            "hbm": self.inner.from_codomain(dense),
            "host": self.inner.alloc(int(dense.shape[0]), dense.device),
        }

    def access(self, buffers, i):
        i = _offsets(i, device_of(buffers))
        hbm = self.inner.access(buffers["hbm"], i)
        host = self.inner.access(buffers["host"], i)
        return torch.where(self._route(i), host, hbm)

    def store(self, buffers, i, value):
        """Route each store to the space holding its page. Mixed batches write
        both sets with the complementary halves masked to their old values —
        the functional-update analogue of two partial scatters."""
        i = _offsets(i, device_of(buffers))
        in_host = self._route(i)
        old_h = self.inner.access(buffers["host"], i)
        old_b = self.inner.access(buffers["hbm"], i)
        value = as_tensor(value, old_b.dtype, old_b.device)
        return {
            "hbm": self.inner.store(buffers["hbm"], i, torch.where(in_host, old_b, value)),
            "host": self.inner.store(buffers["host"], i, torch.where(in_host, value, old_h)),
        }

    def decay(self, buffers):
        """Flatten to one plain codomain: each page read from its residency."""
        hbm = self.inner.decay(buffers["hbm"])
        host = self.inner.decay(buffers["host"])
        idx = torch.arange(hbm.shape[0], device=hbm.device)
        return torch.where(self._route(idx), host, hbm)

    def bytes_for_offsets(self, i) -> int:
        return self.inner.bytes_for_offsets(i)

    def migrate(self, buffers, page: int, to: MemorySpace):
        """Move one page's content between spaces: copy its ``page_elems``
        offsets through the inner accessor, return (buffers, accessor) with the
        residency set updated. The offsets never change — only which buffer set
        answers them."""
        here = self.space_for_offset(page * self.page_elems)
        if to == here:
            return buffers, self
        src, dst = ("host", "hbm") if to == MemorySpace.HBM else ("hbm", "host")
        offs = torch.arange(page * self.page_elems, (page + 1) * self.page_elems,
                            device=device_of(buffers))
        vals = self.inner.access(buffers[src], offs)
        buffers = {**buffers, dst: self.inner.store(buffers[dst], offs, vals)}
        pages = set(self.host_pages)
        (pages.discard if to == MemorySpace.HBM else pages.add)(page)
        return buffers, dataclasses.replace(self, host_pages=tuple(sorted(pages)))
