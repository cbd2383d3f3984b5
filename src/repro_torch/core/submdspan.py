"""submdspan — the paper's ``subspan``: arbitrary rectangular slices of an MdSpan.

Port of ``repro.core.submdspan`` (pure index arithmetic, the same semantics).

Slice specifiers (P0009's verbose-but-composable model):
  * an integer  — fix that rank (rank is dropped from the result)
  * ``all``     — keep the whole rank (static extent is preserved)
  * ``(a, b)``  — the half-open range [a, b)  (C++ ``pair{a, b}``; extent becomes
                  dynamic, matching P0009)

The result SHARES the parent's buffers — a subspan is pure index arithmetic that
folds into the layout (a ``LayoutStride`` with a base offset); no element moves.

Chunk views are submdspans (the paged regime)
---------------------------------------------
The serving engine's chunked prefill is this module applied to ``LayoutPaged``:
a prefill chunk — the tokens one mixed engine step computes for one sequence —
is the pos-range slice ``submdspan(seq_view, all_, all_, (a, b), all_)`` of that
sequence's paged cache view, and ``LayoutPaged.slice_layout`` makes the result
a LayoutPaged again: rows trimmed to exactly the pages covering ``[a, b)``,
with ``pos_offset`` recording where inside the first page the chunk begins.
No bytes move; the chunk is index arithmetic over the same pool, exactly as a
``LayoutStride`` subspan is over a dense buffer.

The laws (the reference's tests/test_submdspan_paged.py, held against the
port in tests/test_torch_core.py):
  * pointwise:  ``sub(s, h, p, d) == parent(s, h, a + p, d)`` for every index —
    including partial-page boundaries, where ``a % page_size != 0`` shifts the
    slot arithmetic by ``pos_offset`` instead of re-tiling anything;
  * composition: slicing a slice equals one slice with the composed range
    (``(a, b)`` then ``(c, d)`` == ``(a + c, a + d)``), the P0009 subspan law;
  * aliasing:   ``shared_pages`` filters to the pages the chunk references, so
    a chunk lying entirely past a shared prefix is ``is_unique()`` even when
    the parent view is not. This is the formal shape of the shared-prefix
    compute skip: the engine may start a request's first chunk at the first
    non-shared token precisely because that chunk's view owns its pages — the
    skipped prefix stays a read-only alias of the donor's;
  * accessor orthogonality (paper Table II): the slice transforms only the
    LAYOUT; reading a chunk of a quantized pool decodes through the same
    accessor and then gathers through the sliced offsets, so chunk reads
    commute with dequantization.

A speculative verify window is the same pos-range slice at width K+1, and
rolling back rejected tokens shrinks the view's length without touching the
pool (the reference's serving/speculative.py; not ported yet).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from .extents import Extents
from .layouts import LayoutMapping
from .mdspan import MdSpan


class _All:
    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):  # pragma: no cover
        return "all"


#: slice-everything sentinel (paper: ``std::full_extent`` / Kokkos ``ALL``)
all_ = _All()


@dataclasses.dataclass(frozen=True)
class SliceShape:
    """Resolved slice geometry handed to LayoutMapping.slice_layout."""

    extents: Extents          # extents of the sub-view (kept ranks only)
    keep: Tuple[bool, ...]    # per-parent-rank: does it survive into the sub-view?


def _resolve(spec, parent: Extents):
    if len(spec) != parent.rank:
        raise TypeError(f"{len(spec)} slice specifiers for rank-{parent.rank} mdspan")
    starts, keep, new_statics, new_sizes = [], [], [], []
    for r, s in enumerate(spec):
        psize = parent.extent(r)
        if isinstance(s, _All):
            starts.append(0)
            keep.append(True)
            new_statics.append(parent.static_extent(r))
            new_sizes.append(psize)
        elif isinstance(s, tuple) and len(s) == 2:
            a, b = int(s[0]), int(s[1])
            if not (0 <= a <= b <= psize):
                raise IndexError(f"slice ({a},{b}) out of bounds for extent {psize}")
            starts.append(a)
            keep.append(True)
            new_statics.append(None)  # P0009: pair slices yield dynamic extents
            new_sizes.append(b - a)
        elif isinstance(s, int):
            if not (0 <= s < psize) and psize > 0:
                raise IndexError(f"index {s} out of bounds for extent {psize}")
            starts.append(int(s))
            keep.append(False)
        else:
            raise TypeError(f"bad slice specifier {s!r}")
    sub_ext = Extents(tuple(new_statics), tuple(new_sizes))
    return starts, SliceShape(sub_ext, tuple(keep))


def submdspan(span: MdSpan, *spec) -> MdSpan:
    """Slice an MdSpan. Shares buffers; composes layouts; zero runtime cost."""
    starts, shape = _resolve(spec, span.extents)
    sub_layout: LayoutMapping = span.layout.slice_layout(starts, shape)
    # Accessor offset policy (paper Table II): rebasing may change the accessor
    # type (e.g. alignment-carrying spaces decay). We keep the base offset inside
    # the layout, so only the *policy* transition applies, not a buffer rebase.
    accessor = span.accessor.offset_policy
    return MdSpan(span.buffers, sub_layout, accessor)
