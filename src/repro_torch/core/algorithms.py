"""Layout-generic algorithms over MdSpans, with property gating.

Port of ``repro.core.algorithms``. An algorithm states its layout
requirements through the Table I property queries and either specializes or
raises LayoutError before it computes anything (the paper's compile-time
rejection):

  scale(s, a)   needs every multi-index to alias a distinct offset (is_unique) OR a
                contiguous codomain it can treat as 1-D (is_contiguous) — the paper's
                exact example, including why symmetric-packed storage would
                double-scale off-diagonals under the naive loop.
  dot(a, b)     needs NO uniqueness (paper's counter-example): reads only.
  fill / copy / reduce_sum / matvec / add_into — further consumers of the same gates.

Accessor-aware fast path: scaling a contiguous QuantizedAccessor view multiplies
only the per-block scales (bytes touched: nblocks, not span).
"""
from __future__ import annotations

import torch

from .accessors import AccumulateAccessor, BasicAccessor, QuantizedAccessor
from .layouts import LayoutError
from .mdspan import MdSpan


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise LayoutError(msg)


def scale(span: MdSpan, alpha) -> MdSpan:
    """span *= alpha, layout-generically. Paper §Layout abstraction."""
    if span.is_contiguous():
        # Operate on the codomain as a 1-D mdspan (paper's contiguous fast path).
        acc = span.accessor
        if isinstance(acc, QuantizedAccessor):
            # Accessor-aware: scaling commutes with dequantization.
            bufs = dict(span.buffers)
            bufs["scale"] = bufs["scale"] * torch.tensor(alpha, dtype=torch.float32)
            return span.with_buffers(bufs)
        if isinstance(acc, BasicAccessor):
            return span.with_buffers(span.buffers * torch.tensor(alpha, dtype=acc.element_type))
        # generic contiguous: decay -> scale -> re-encode
        return span.with_buffers(acc.from_codomain(acc.decay(span.buffers) * alpha))
    _require(
        span.is_unique(),
        "scale() over the index domain requires a unique layout (symmetric-packed "
        "storage would double-scale off-diagonal entries) or a contiguous codomain",
    )
    offs = span.layout.offsets_dense(span.device).reshape(-1)
    vals = span.accessor.access(span.buffers, offs)
    return span.with_buffers(span.accessor.store(span.buffers, offs, vals * alpha))


def fill(span: MdSpan, value) -> MdSpan:
    """Every index of the domain set to ``value`` (idempotent, so a non-unique
    layout is fine)."""
    acc = span.accessor
    if span.is_contiguous():
        codo = torch.full((span.layout.required_span_size(),), value,
                          dtype=acc.element_type, device=span.device)
        return span.with_buffers(acc.from_codomain(codo))
    offs = span.layout.offsets_dense(span.device).reshape(-1)
    return span.with_buffers(acc.store(span.buffers, offs, value))


def copy(dst: MdSpan, src: MdSpan) -> MdSpan:
    """dst[i...] = src[i...] over the common domain. Needs unique dst."""
    _require(dst.shape == src.shape, f"shape mismatch {dst.shape} vs {src.shape}")
    _require(
        dst.is_unique() or isinstance(dst.accessor, AccumulateAccessor),
        "copy() into a non-unique layout is ill-defined",
    )
    offs = dst.layout.offsets_dense(dst.device).reshape(-1)
    vals = src.to_dense().reshape(-1)
    return dst.with_buffers(dst.accessor.store(dst.buffers, offs, vals))


def reduce_sum(span: MdSpan) -> torch.Tensor:
    """Sum over the INDEX DOMAIN (not the codomain): symmetric-packed counts
    off-diagonals twice, as the math requires. No uniqueness needed (read-only)."""
    return torch.sum(span.to_dense())


def dot(a: MdSpan, b: MdSpan) -> torch.Tensor:
    """Paper's example of an algorithm with no uniqueness requirement."""
    _require(a.shape == b.shape, f"shape mismatch {a.shape} vs {b.shape}")
    return torch.sum(a.to_dense() * b.to_dense())


def matvec(A: MdSpan, x: MdSpan) -> torch.Tensor:
    """y = A @ x, layout-generically (the MatVec benchmark's semantic spec).

    kernels/ops.py overrides this with layout-specialized CUDA kernels; this body
    is the semantics-only version every layout must satisfy.
    """
    _require(A.rank == 2 and x.rank == 1, "matvec needs rank-2 A, rank-1 x")
    _require(A.extent(1) == x.extent(0), "inner extent mismatch")
    return A.to_dense() @ x.to_dense()


def add_into(dst: MdSpan, src: MdSpan) -> MdSpan:
    """dst += src. For non-unique dst layouts this requires accumulate semantics
    (the atomic-accessor use case)."""
    _require(dst.shape == src.shape, "shape mismatch")
    offs = dst.layout.offsets_dense(dst.device).reshape(-1)
    if not dst.is_unique():
        _require(
            isinstance(dst.accessor, AccumulateAccessor),
            "accumulation into a non-unique layout requires AccumulateAccessor "
            "(the paper's atomic use case)",
        )
        # Each codomain slot must receive the sum of ALL domain contributions.
        return dst.with_buffers(
            dst.accessor.store(dst.buffers, offs, src.to_dense().reshape(-1))
        )
    cur = dst.accessor.access(dst.buffers, offs)
    return dst.with_buffers(
        dst.accessor.store(dst.buffers, offs, cur + src.to_dense().reshape(-1))
    )
