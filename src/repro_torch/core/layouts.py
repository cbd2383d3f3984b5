"""LayoutMapping: the paper's Table I concept, in PyTorch.

Port of ``repro.core.layouts``. A LayoutMapping is a pure function from a
multi-index in the extents' domain to a scalar offset in the codomain (a flat
buffer), carrying queryable algebraic properties. Algorithms
(core/algorithms.py, kernels/ops.py) interrogate these properties before
they launch anything, and specialize or reject: the eager analogue of the
paper's "fail at compile time rather than run time".

Implemented mappings:
  LayoutRight           row-major (fast-running index right-most)        [paper]
  LayoutLeft            column-major (fast-running index left-most)      [paper]
  LayoutStride          arbitrary per-rank strides + base offset (BLAS LD) [paper]
  LayoutSymmetricPacked upper-triangle packed storage — NON-unique        [paper]
  LayoutTiledTPU        the reference's (8,128)-style tiling with padding; a
                        pure index map here (no kernel of the port tiles for
                        a TPU), kept under its name so the two packages agree
                        offset for offset
  LayoutPaged           block-table indirection for paged KV caches: logical
                        (seq, head, pos, d) → physical (page, slot) through a
                        per-sequence page table; unique (when the table doesn't
                        alias), non-contiguous, non-strided               [extension]

Every ``__call__`` accepts Python ints (and returns an int) or int64 index
tensors (and returns a tensor on their device), so a mapping serves both
scalar element access and whole-domain gathers. ``offsets_dense()`` returns
int64 (the reference returns int32; its values are the same).
"""
from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from .accessors import MemorySpace
from .device import resolve_device
from .extents import Extents


class LayoutError(TypeError):
    """Raised when an algorithm cannot support a layout (paper: a failed
    compile-time constraint), before anything runs."""


def _all_int(idx) -> bool:
    return all(isinstance(i, int) for i in idx)


class LayoutMapping:
    """Base class documenting the concept (paper Table I)."""

    extents: Extents

    # -- required observers ---------------------------------------------------
    def __call__(self, *idx):  # -> offset (int or int64 tensor)
        raise NotImplementedError

    def required_span_size(self) -> int:
        raise NotImplementedError

    def is_unique(self) -> bool:
        raise NotImplementedError

    def is_contiguous(self) -> bool:
        raise NotImplementedError

    def is_strided(self) -> bool:
        raise NotImplementedError

    def stride(self, r: int) -> int:
        raise LayoutError(f"{type(self).__name__} is not strided")

    # -- static forms -----------------------------------------------------------
    @classmethod
    def is_always_unique(cls) -> bool:
        return False

    @classmethod
    def is_always_contiguous(cls) -> bool:
        return False

    @classmethod
    def is_always_strided(cls) -> bool:
        return False

    # -- slicing support (submdspan) ----------------------------------------------
    def slice_layout(self, starts: Sequence[int], shape_spec) -> "LayoutMapping":
        """Return the layout of a rectangular sub-view. Default: only defined for
        strided layouts (LayoutStride result); others must override or reject."""
        raise LayoutError(
            f"submdspan of {type(self).__name__} is not defined (not strided)"
        )

    # -- misc -------------------------------------------------------------------
    @property
    def rank(self) -> int:
        return self.extents.rank

    def offsets_dense(self, device=None) -> torch.Tensor:
        """Offsets for the whole domain as an int64 tensor shaped like the
        extents, on ``device`` (None: ``resolve_device``, i.e. CUDA). Used by
        generic gather/scatter paths and oracles; O(domain size)."""
        device = resolve_device(device)
        shape = self.extents.as_shape()
        if not shape:  # rank-0
            return torch.zeros((), dtype=torch.int64, device=device)
        grids = torch.meshgrid(
            *(torch.arange(s, dtype=torch.int64, device=device) for s in shape), indexing="ij"
        )
        off = self(*grids)
        if not isinstance(off, torch.Tensor):  # a map constant over the domain
            off = torch.full(shape, int(off), dtype=torch.int64, device=device)
        return off


def _row_major_strides(sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    strides = [1] * len(sizes)
    for r in range(len(sizes) - 2, -1, -1):
        strides[r] = strides[r + 1] * sizes[r + 1]
    return tuple(strides)


def _col_major_strides(sizes: Tuple[int, ...]) -> Tuple[int, ...]:
    strides = [1] * len(sizes)
    for r in range(1, len(sizes)):
        strides[r] = strides[r - 1] * sizes[r - 1]
    return tuple(strides)


@dataclasses.dataclass(frozen=True)
class _StridedBase(LayoutMapping):
    extents: Extents

    def _strides(self) -> Tuple[int, ...]:
        raise NotImplementedError

    def __call__(self, *idx):
        strides = self._strides()
        if len(idx) != len(strides):
            raise TypeError(f"rank mismatch: {len(idx)} indices for rank {len(strides)}")
        off = self._base_offset()
        for i, s in zip(idx, strides):
            off = off + i * s
        return off

    def _base_offset(self) -> int:
        return 0

    def is_unique(self) -> bool:
        return True

    def is_strided(self) -> bool:
        return True

    def stride(self, r: int) -> int:
        return self._strides()[r]

    @classmethod
    def is_always_unique(cls) -> bool:
        return True

    @classmethod
    def is_always_strided(cls) -> bool:
        return True

    def slice_layout(self, starts, shape_spec):
        strides = self._strides()
        base = self._base_offset() + sum(int(s) * int(st) for s, st in zip(starts, strides))
        kept_strides = tuple(
            strides[r] for r, keep in enumerate(shape_spec.keep) if keep
        )
        return LayoutStride(shape_spec.extents, kept_strides, base)


@dataclasses.dataclass(frozen=True)
class LayoutRight(_StridedBase):
    """Row-major; the C++ default and the paper's ``layout_right``."""

    def _strides(self):
        return _row_major_strides(self.extents.sizes)

    def required_span_size(self) -> int:
        return self.extents.size()

    def is_contiguous(self) -> bool:
        return True

    @classmethod
    def is_always_contiguous(cls) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class LayoutLeft(_StridedBase):
    """Column-major; the paper's ``layout_left`` (Fortran/BLAS default)."""

    def _strides(self):
        return _col_major_strides(self.extents.sizes)

    def required_span_size(self) -> int:
        return self.extents.size()

    def is_contiguous(self) -> bool:
        return True

    @classmethod
    def is_always_contiguous(cls) -> bool:
        return True


@dataclasses.dataclass(frozen=True)
class LayoutStride(_StridedBase):
    """Arbitrary strides + base offset (generalizes BLAS leading-dimension and every
    rectangular submdspan of a strided layout)."""

    strides: Tuple[int, ...] = ()
    offset: int = 0

    def __post_init__(self):
        if len(self.strides) != self.extents.rank:
            raise TypeError(
                f"{len(self.strides)} strides for rank-{self.extents.rank} extents"
            )

    def _strides(self):
        return self.strides

    def _base_offset(self) -> int:
        return self.offset

    def required_span_size(self) -> int:
        if self.extents.size() == 0:
            return 0
        last = self.offset
        for sz, st in zip(self.extents.sizes, self.strides):
            last += (sz - 1) * st
        return last + 1

    def is_unique(self) -> bool:
        # Sufficient check: sorted (|stride|, size) nest like a mixed-radix system.
        dims = sorted(
            (abs(st), sz) for st, sz in zip(self.strides, self.extents.sizes) if sz > 1
        )
        span = 1
        for st, sz in dims:
            if st < span:
                return False
            span = st * sz
        return True

    def is_contiguous(self) -> bool:
        return (self.is_unique() and self.offset == 0
                and self.required_span_size() - self.offset == self.extents.size())

    @classmethod
    def is_always_unique(cls) -> bool:
        return False  # depends on instance strides

    @classmethod
    def is_always_contiguous(cls) -> bool:
        return False


@dataclasses.dataclass(frozen=True)
class LayoutSymmetricPacked(LayoutMapping):
    """Upper-triangle packed symmetric layout (paper: xSYMM / UPLO).

    Rank-2 n×n domain stored in n(n+1)/2 slots; (i,j) and (j,i) map to the SAME
    offset → **is_unique() == False**. Algorithms requiring uniqueness (e.g. `scale`
    iterating the full domain) must reject this layout; algorithms generic over
    contiguous codomains may operate on the packed buffer directly.
    """

    extents: Extents

    def __post_init__(self):
        if self.extents.rank != 2 or self.extents.extent(0) != self.extents.extent(1):
            raise TypeError("LayoutSymmetricPacked requires square rank-2 extents")

    def __call__(self, i, j):
        if _all_int((i, j)):
            lo, hi = min(i, j), max(i, j)
        else:
            i, j = torch.as_tensor(i), torch.as_tensor(j)
            lo, hi = torch.minimum(i, j), torch.maximum(i, j)
        # packed upper triangle, row-major over (lo, hi): offset = lo*n - lo(lo-1)/2 + (hi-lo)
        n = self.extents.extent(0)
        return lo * n - (lo * (lo - 1)) // 2 + (hi - lo)

    def required_span_size(self) -> int:
        n = self.extents.extent(0)
        return n * (n + 1) // 2

    def is_unique(self) -> bool:
        return self.extents.extent(0) <= 1

    def is_contiguous(self) -> bool:
        return True  # codomain is exactly [0, n(n+1)/2)

    def is_strided(self) -> bool:
        return False

    @classmethod
    def is_always_contiguous(cls) -> bool:
        return True


# The reference's tile shapes per element byte-width (sublane × lane).
_TPU_TILE_BY_ITEMSIZE = {4: (8, 128), 2: (16, 128), 1: (32, 128)}


@dataclasses.dataclass(frozen=True)
class LayoutTiledTPU(LayoutMapping):
    """The reference's TPU-native tiled layout: the last two dims blocked into
    (sublane, lane) tiles, (8, 128) for 4-byte elements, so that a TPU's
    vector-memory loads fill its vector registers and matrix-unit operands are
    aligned. In the port it is a pure index map (no port kernel consumes it),
    kept under the reference's name so both packages agree offset for offset.
    Logical (i, j) maps to

        tile = (i // ts) * ceil(J/tl) + (j // tl)
        offset = tile * ts * tl + (i % ts) * tl + (j % tl)

    Padding tiles at the edges makes the codomain larger than the domain →
    ``is_contiguous() == False`` unless the extents divide the tile exactly; the map
    stays unique. It is NOT globally strided (stride between (i,j)->(i,j+1) changes
    at tile boundaries) → kernels requiring `is_strided` reject it.

    Leading dims (rank > 2) are row-major over whole tiled planes.
    """

    extents: Extents
    tile: Tuple[int, int] = (8, 128)

    def __post_init__(self):
        if self.extents.rank < 2:
            raise TypeError("LayoutTiledTPU requires rank >= 2")

    @staticmethod
    def for_dtype(extents: Extents, dtype: torch.dtype) -> "LayoutTiledTPU":
        return LayoutTiledTPU(extents, _TPU_TILE_BY_ITEMSIZE.get(dtype.itemsize, (8, 128)))

    def _tiles(self):
        I, J = self.extents.sizes[-2:]
        ts, tl = self.tile
        return -(-I // ts), -(-J // tl)  # ceil-div

    def plane_span(self) -> int:
        ti, tj = self._tiles()
        return ti * tj * self.tile[0] * self.tile[1]

    def __call__(self, *idx):
        *lead, i, j = idx
        ts, tl = self.tile
        ti, tj = self._tiles()
        off = (i // ts) * (tj * ts * tl) + (j // tl) * (ts * tl) + (i % ts) * tl + (j % tl)
        plane = self.plane_span()
        lead_sizes = self.extents.sizes[:-2]
        lead_strides = _row_major_strides(lead_sizes) if lead_sizes else ()
        for l, s in zip(lead, lead_strides):
            off = off + l * s * plane
        return off

    def required_span_size(self) -> int:
        n_planes = 1
        for s in self.extents.sizes[:-2]:
            n_planes *= s
        return n_planes * self.plane_span()

    def is_unique(self) -> bool:
        return True

    def is_contiguous(self) -> bool:
        I, J = self.extents.sizes[-2:]
        return I % self.tile[0] == 0 and J % self.tile[1] == 0

    def is_strided(self) -> bool:
        # Conservative type-level answer: tile-boundary jumps break global strides
        # (degenerate single-tile instances are not special-cased).
        return False

    @classmethod
    def is_always_unique(cls) -> bool:
        return True

    def padded_shape(self) -> Tuple[int, ...]:
        ti, tj = self._tiles()
        return self.extents.sizes[:-2] + (ti * self.tile[0], tj * self.tile[1])


@dataclasses.dataclass(frozen=True)
class LayoutPaged(LayoutMapping):
    """Paged KV-cache layout: logical positions reach physical storage through a
    block table (vLLM-style PagedAttention, restated as a layout mapping).

    The domain is rank-4 ``(seq, head, pos, d)``. Physical storage is a pool of
    ``num_pages`` fixed-size pages, each holding ``page_size`` positions for all
    heads — pool shape ``(num_pages, n_heads, page_size, d)`` flattened row-major:

        page   = block_table[seq][pos // page_size]
        slot   = pos %  page_size
        offset = ((page * n_heads + head) * page_size + slot) * d + d_idx

    The indirection through ``block_table`` makes the map non-affine, so it is
    NOT strided and (because the pool is over-provisioned) NOT contiguous, yet
    it IS unique whenever the table doesn't alias pages. The port's paged
    attention kernels (kernels/csrc/paged_attention.cu) read the same
    (page, head, slot, d) pool through the same table.

    ``block_table`` is a tuple-of-tuples (hashable); rows are logical pages in
    order. Entries must be in ``[0, num_pages)`` — use a reserved null page for
    unallocated tail entries and keep those positions masked.

    Composing with accessors (paper §customization points): this mapping never
    inspects element bytes, so serving/engine/kvquant.PagedQuantSpec stores the
    SAME codomain as block-scaled int8/int4 (one scale per (page, head)), and
    every law below holds identically over the quantized pool.

    ``shared_pages`` names physical pages referenced by block tables OUTSIDE this
    instance (prefix sharing). ``is_unique()`` reports False exactly when the
    table references a shared page (or aliases a page internally). ``fork()``
    builds the aliased regime explicitly; ``cow_slice()`` is the copy-on-write
    swap that re-privatizes one logical page.

    Slicing (submdspan — the chunked-prefill view): a ``(a, b)`` slice of the
    pos rank yields another LayoutPaged whose block-table rows are trimmed to
    exactly the pages covering ``[a, b)`` and whose ``pos_offset`` records where
    inside the first page the chunk begins; ``shared_pages`` is filtered to the
    pages the chunk still references, so a chunk past a shared prefix is
    ``is_unique()`` even when its parent is not (core/submdspan.py).

    ``host_pages`` is the per-page residency set of a host memory tier, which
    makes index -> (space, page, slot) a total map (``space_for`` /
    ``space_for_offset``); it never changes an offset.
    """

    extents: Extents
    block_table: Tuple[Tuple[int, ...], ...] = ()
    page_size: int = 16
    num_pages: int = 0
    shared_pages: Tuple[int, ...] = ()
    pos_offset: int = 0  # physical position of logical pos 0 within the first page
    host_pages: Tuple[int, ...] = ()  # physical pages currently host-resident

    def __post_init__(self):
        if self.extents.rank != 4:
            raise TypeError("LayoutPaged requires rank-4 (seq, head, pos, d) extents")
        n_seq, _, max_pos, _ = self.extents.sizes
        if self.page_size <= 0:
            raise ValueError("page_size must be positive")
        if not (0 <= self.pos_offset < self.page_size):
            raise ValueError(
                f"pos_offset {self.pos_offset} outside [0, page_size {self.page_size})"
            )
        table = tuple(tuple(int(p) for p in row) for row in self.block_table)
        object.__setattr__(self, "block_table", table)
        if len(table) != n_seq:
            raise TypeError(f"{len(table)} block-table rows for {n_seq} sequences")
        # rows must cover the (offset-shifted) pos domain exactly
        pages_per_seq = -(-(self.pos_offset + max_pos) // self.page_size)
        for row in table:
            if len(row) != pages_per_seq:
                raise TypeError(
                    f"block-table row of {len(row)} entries; need {pages_per_seq}"
                )
            for p in row:
                if not (0 <= p < self.num_pages):
                    raise ValueError(f"page id {p} outside pool [0, {self.num_pages})")
        shared = tuple(sorted({int(p) for p in self.shared_pages}))
        object.__setattr__(self, "shared_pages", shared)
        for p in shared:
            if not (0 <= p < self.num_pages):
                raise ValueError(f"shared page id {p} outside pool [0, {self.num_pages})")
        host = tuple(sorted({int(p) for p in self.host_pages}))
        object.__setattr__(self, "host_pages", host)
        for p in host:
            if not (0 <= p < self.num_pages):
                raise ValueError(f"host page id {p} outside pool [0, {self.num_pages})")

    @staticmethod
    def dense(n_seq: int, n_heads: int, max_pos: int, d: int, page_size: int) -> "LayoutPaged":
        """Identity block table covering the domain exactly (the LayoutRight
        cross-check instance: no over-provisioning, pages in logical order)."""
        pages_per_seq = max_pos // page_size
        table = tuple(
            tuple(s * pages_per_seq + j for j in range(pages_per_seq))
            for s in range(n_seq)
        )
        return LayoutPaged(
            Extents.fully_dynamic(n_seq, n_heads, max_pos, d),
            table, page_size, n_seq * pages_per_seq,
        )

    # -- mapping ------------------------------------------------------------------
    def _table_tensor(self, device) -> torch.Tensor:
        n_seq = len(self.block_table)
        width = len(self.block_table[0]) if n_seq else 0
        return torch.tensor(self.block_table, dtype=torch.int64, device=device).reshape(
            n_seq, width)

    def __call__(self, s, h, p, d):
        _, n_heads, _, d_sz = self.extents.sizes
        ps = self.page_size
        phys = p + self.pos_offset
        if _all_int((s, h, p, d)):
            page = self.block_table[s][phys // ps]
        else:
            tensors = [i for i in (s, h, p, d) if isinstance(i, torch.Tensor)]
            device = tensors[0].device if tensors else None
            page = self._table_tensor(device)[torch.as_tensor(s, device=device),
                                              torch.as_tensor(phys // ps, device=device)]
        slot = phys % ps
        return ((page * n_heads + h) * ps + slot) * d_sz + d

    def pool_shape(self) -> Tuple[int, int, int, int]:
        """The codomain factored as a tensor: (num_pages, n_heads, page_size, d)."""
        return (self.num_pages, self.extents.extent(1), self.page_size, self.extents.extent(3))

    # -- memory spaces (hierarchical KV) -------------------------------------------
    def space_for(self, s: int, h: int, p: int, d: int) -> MemorySpace:
        """The memory space holding index (s, h, p, d) — HOST when the page the
        position maps to is in the residency set, HBM otherwise (the same
        answer accessors.HostTierAccessor gives from the accessor axis)."""
        page = self.block_table[s][(p + self.pos_offset) // self.page_size]
        return MemorySpace.HOST if page in set(self.host_pages) else MemorySpace.HBM

    def space_for_offset(self, offset: int) -> MemorySpace:
        """The memory space holding flat codomain ``offset`` (total over the
        span: offsets factor through pages, and residency is per page)."""
        page_elems = self.extents.extent(1) * self.page_size * self.extents.extent(3)
        page = int(offset) // page_elems
        if not (0 <= page < self.num_pages):
            raise ValueError(
                f"offset {offset} outside the pool span [0, {self.required_span_size()})"
            )
        return MemorySpace.HOST if page in set(self.host_pages) else MemorySpace.HBM

    # -- observers ----------------------------------------------------------------
    def required_span_size(self) -> int:
        return self.num_pages * self.extents.extent(1) * self.page_size * self.extents.extent(3)

    def is_unique(self) -> bool:
        entries = [p for row in self.block_table for p in row]
        if len(entries) != len(set(entries)):
            return False  # two logical positions alias one (page, slot) internally
        shared = set(self.shared_pages)
        return not any(p in shared for p in entries)

    def is_contiguous(self) -> bool:
        if self.pos_offset != 0 or self.extents.extent(2) % self.page_size != 0:
            return False  # a chunk view leaves page slack around its boundaries
        entries = sorted(p for row in self.block_table for p in row)
        return entries == list(range(self.num_pages))

    def is_strided(self) -> bool:
        # Type-level answer: the table indirection breaks affine strides
        # (identity-table instances are not special-cased).
        return False

    # -- slicing (submdspan): chunk views -----------------------------------------
    def slice_layout(self, starts: Sequence[int], shape_spec) -> "LayoutPaged":
        """The layout of a rectangular sub-view — the chunked-prefill law.

        Only seq and pos may be restricted (``all_`` or ``(a, b)`` ranges): the
        head and d ranks are interleaved INSIDE each page by the offset formula,
        and integer specifiers would drop the rank-4 structure the block table
        addresses — both raise LayoutError. A pos slice trims each row to
        exactly the pages covering ``[a, b)`` and records the in-page start as
        ``pos_offset``; composing slices is associative.
        """
        if len(shape_spec.keep) != 4 or not all(shape_spec.keep):
            raise LayoutError(
                "submdspan of LayoutPaged must keep all four ranks "
                "(integer specifiers would drop the block-table structure)"
            )
        s0, h0, p0, _d0 = (int(s) for s in starts)
        sizes = shape_spec.extents.sizes
        if h0 != 0 or sizes[1] != self.extents.extent(1):
            raise LayoutError(
                "LayoutPaged head rank only slices with all_ (heads interleave "
                "inside each physical page)"
            )
        if sizes[3] != self.extents.extent(3):
            raise LayoutError(
                "LayoutPaged d rank only slices with all_ (d is innermost in "
                "each page)"
            )
        rows = self.block_table[s0 : s0 + sizes[0]]
        phys0 = self.pos_offset + p0
        first_page = phys0 // self.page_size
        last_page = -(-(phys0 + sizes[2]) // self.page_size)  # exclusive
        new_rows = tuple(r[first_page:last_page] for r in rows)
        referenced = {p for r in new_rows for p in r}
        shared = tuple(p for p in self.shared_pages if p in referenced)
        return LayoutPaged(
            shape_spec.extents,
            new_rows,
            self.page_size,
            self.num_pages,
            shared,
            phys0 - first_page * self.page_size,
            host_pages=tuple(p for p in self.host_pages if p in referenced),
        )

    # -- prefix sharing / copy-on-write / parallel generation ----------------------
    # A layout is a customization point: parallel decoding is a new mapping, not
    # a new kernel. best-of-n forks rows (``fork_group``: n rows aliasing one
    # prompt's pages; ``is_unique()`` goes False until ``cow_slice`` privatizes
    # every doubly-referenced page); a beam step that keeps every hypothesis
    # alive once is ``permute_rows``, a relabeling with an unchanged offset image.
    def fork(self, seq: int, fresh_pages: Sequence[int] = ()) -> "LayoutPaged":
        """A new layout with one more sequence row that shares row ``seq``'s
        leading pages (prefix sharing). The forked row reuses row ``seq``'s first
        ``pages_per_seq - len(fresh_pages)`` entries and takes ``fresh_pages``
        as its tail. The shared entries now appear in two rows, so
        ``is_unique()`` goes False until ``cow_slice`` resolves every
        doubly-referenced page. ``shared_pages`` is carried through unchanged."""
        rows = list(self.block_table)
        if not (0 <= seq < len(rows)):
            raise ValueError(f"no sequence {seq} to fork (have {len(rows)} rows)")
        row = rows[seq]
        fresh = tuple(int(p) for p in fresh_pages)
        if len(fresh) > len(row):
            raise ValueError(f"{len(fresh)} fresh pages for a {len(row)}-page row")
        upto = len(row) - len(fresh)
        rows.append(row[:upto] + fresh)
        sizes = self.extents.sizes
        return LayoutPaged(
            Extents.fully_dynamic(sizes[0] + 1, *sizes[1:]),
            tuple(rows),
            self.page_size,
            self.num_pages,
            self.shared_pages,
            self.pos_offset,
            host_pages=self.host_pages,
        )

    def fork_group(self, seq: int, n: int,
                   fresh_pages: Sequence[Sequence[int]] = ()) -> "LayoutPaged":
        """``n`` forks of row ``seq`` in one step (a branch group's admission);
        ``fresh_pages`` (optional, one tuple per branch) gives branch ``i`` its
        private tail. Equivalent to ``n`` successive ``fork(seq, ...)`` calls."""
        if n < 1:
            raise ValueError(f"fork_group needs n >= 1, got {n}")
        fresh = list(fresh_pages) or [()] * n
        if len(fresh) != n:
            raise ValueError(f"{len(fresh)} fresh-page tails for {n} branches")
        out = self
        for tail in fresh:
            out = out.fork(seq, tail)
        return out

    def permute_rows(self, perm: Sequence[int]) -> "LayoutPaged":
        """The layout after a beam-search reorder step: row ``i`` of the result
        is row ``perm[i]`` of this layout. ``perm`` must be a permutation of
        ``range(n_seq)``, so the offset image is unchanged: no page is copied,
        no entry rewritten."""
        rows = self.block_table
        if sorted(int(p) for p in perm) != list(range(len(rows))):
            raise ValueError(
                f"perm {tuple(perm)} is not a permutation of range({len(rows)})"
            )
        return LayoutPaged(
            self.extents,
            tuple(rows[int(p)] for p in perm),
            self.page_size,
            self.num_pages,
            self.shared_pages,
            self.pos_offset,
            host_pages=self.host_pages,
        )

    def cow_slice(self, seq: int, logical_page: int, new_page: int) -> "LayoutPaged":
        """The layout after a copy-on-write: row ``seq``'s ``logical_page`` entry
        is swapped for the freshly copied ``new_page`` (private, so not shared).
        The donor page leaves ``shared_pages`` once no row references it."""
        rows = [list(r) for r in self.block_table]
        if not (0 <= seq < len(rows)):
            raise ValueError(f"no sequence {seq} to cow (have {len(rows)} rows)")
        if not (0 <= logical_page < len(rows[seq])):
            raise ValueError(
                f"no logical page {logical_page} in a {len(rows[seq])}-page row"
            )
        old = rows[seq][logical_page]
        rows[seq][logical_page] = int(new_page)
        table = tuple(tuple(r) for r in rows)
        still_referenced = {p for row in table for p in row}
        shared = tuple(
            p for p in self.shared_pages if p != old or p in still_referenced
        )
        return LayoutPaged(
            self.extents, table, self.page_size, self.num_pages, shared,
            self.pos_offset,
            # the fresh CoW target lives in device memory by construction; the
            # donor keeps whatever residency it had
            host_pages=tuple(p for p in self.host_pages if p != new_page),
        )


def layout_of_dense(arr_shape: Sequence[int], order: str = "right") -> LayoutMapping:
    e = Extents.fully_dynamic(*arr_shape)
    return LayoutRight(e) if order == "right" else LayoutLeft(e)
