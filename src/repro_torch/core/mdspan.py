"""MdSpan: a non-owning multi-dimensional view = buffers × layout × accessor.

Port of ``repro.core.mdspan``, the restatement of
``std::basic_mdspan<T, Extents, Layout, Accessor>``:

  * ``buffers``  — a tensor or a dict of tensors (the "pointer"; main storage +
                   accessor auxiliaries such as quantization scales). Non-owning:
                   an MdSpan is index arithmetic over buffers it never copies.
  * ``layout``   — LayoutMapping: multi-index → codomain offset.
  * ``accessor`` — Accessor: (buffers, offset) → value / functional store.

A plain dataclass (the reference's is a JAX pytree). The layout's TYPE picks
the kernel schedule in ``kernels.ops`` (paper Fig. 6): the Python analogue of
template instantiation, decided before anything launches.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from .accessors import Accessor, AccumulateAccessor, BasicAccessor, as_tensor, device_of
from .extents import Extents, _DynamicExtent
from .layouts import (
    LayoutError, LayoutLeft, LayoutMapping, LayoutRight, LayoutStride, _row_major_strides,
)


@dataclasses.dataclass
class MdSpan:
    buffers: Any
    layout: LayoutMapping
    accessor: Accessor

    # -- observers ----------------------------------------------------------------
    @property
    def extents(self) -> Extents:
        return self.layout.extents

    @property
    def rank(self) -> int:
        return self.extents.rank

    def extent(self, r: int) -> int:
        return self.extents.extent(r)

    @property
    def element_type(self):
        return self.accessor.element_type

    @property
    def shape(self):
        return self.extents.as_shape()

    @property
    def device(self) -> torch.device:
        return device_of(self.buffers)

    def size(self) -> int:
        return self.extents.size()

    def is_unique(self) -> bool:
        return self.layout.is_unique()

    def is_contiguous(self) -> bool:
        return self.layout.is_contiguous()

    def is_strided(self) -> bool:
        return self.layout.is_strided()

    def stride(self, r: int) -> int:
        return self.layout.stride(r)

    # -- element access (the paper's operator()) -----------------------------------
    def __call__(self, *idx):
        return self.accessor.access(self.buffers, self.layout(*idx))

    def __getitem__(self, idx):
        if not isinstance(idx, tuple):
            idx = (idx,)
        return self(*idx)

    def get(self, *idx):
        return self(*idx)

    def set(self, idx, value) -> "MdSpan":
        """Functional store: returns a new MdSpan over updated buffers."""
        if not isinstance(idx, tuple):
            idx = (idx,)
        new_buffers = self.accessor.store(self.buffers, self.layout(*idx), value)
        return MdSpan(new_buffers, self.layout, self.accessor)

    # -- whole-view conversion -------------------------------------------------------
    def to_dense(self) -> torch.Tensor:
        """Materialize the logical array (shape = extents).

        Zero-copy fast paths (the paper's compile-away requirement): identity
        layouts are reshapes, column-major is a permuted view, a contiguous
        row-major sub-block is a slice — all views of the buffer, no gather.
        Generic layouts take one gather through ``offsets_dense``.
        """
        if isinstance(self.accessor, BasicAccessor):
            if isinstance(self.layout, LayoutRight):
                return self.buffers.reshape(self.shape)
            if isinstance(self.layout, LayoutLeft):
                return self.buffers.reshape(self.shape[::-1]).permute(
                    tuple(range(self.rank - 1, -1, -1)))
            if isinstance(self.layout, LayoutStride) and self.layout.strides == _row_major_strides(
                    self.extents.sizes):
                # contiguous row-major sub-block (every `all`-suffixed submdspan)
                off = self.layout.offset
                return self.buffers[off:off + self.extents.size()].reshape(self.shape)
        offs = self.layout.offsets_dense(self.device)
        return self.accessor.access(self.buffers, offs.reshape(-1)).reshape(self.shape)

    def scatter_from_dense(self, dense) -> "MdSpan":
        """Functional whole-domain store. Requires a unique layout unless the
        accessor accumulates (the paper's compile-time gating, checked before
        anything is written)."""
        if not self.layout.is_unique() and not isinstance(self.accessor, AccumulateAccessor):
            raise LayoutError(
                "whole-domain overwrite of a non-unique layout is ill-defined; "
                "use an AccumulateAccessor or a unique layout"
            )
        offs = self.layout.offsets_dense(self.device).reshape(-1)
        new_buffers = self.accessor.store(
            self.buffers, offs, as_tensor(dense, device=self.device).reshape(-1))
        return MdSpan(new_buffers, self.layout, self.accessor)

    def codomain(self) -> torch.Tensor:
        """The flat codomain as a plain tensor (decayed pointer)."""
        return self.accessor.decay(self.buffers)

    def with_buffers(self, buffers) -> "MdSpan":
        return MdSpan(buffers, self.layout, self.accessor)

    # -- constructors --------------------------------------------------------------
    @staticmethod
    def from_dense(
        dense,
        layout: LayoutMapping | None = None,
        accessor: Accessor | None = None,
        static: bool = False,
        device=None,
    ) -> "MdSpan":
        """Encode a dense logical array into an MdSpan with the given layout/accessor.

        ``static=True`` marks every extent static. A tensor stays on its device
        unless ``device`` names one; numpy input goes to ``device`` (None: CUDA,
        ``core.device.resolve_device``).
        """
        dense = as_tensor(dense, device=device)
        shape = tuple(dense.shape)
        ext = Extents.fully_static(*shape) if static else Extents.fully_dynamic(*shape)
        layout = layout if layout is not None else LayoutRight(ext)
        accessor = accessor if accessor is not None else BasicAccessor(dense.dtype)
        if layout.extents.as_shape() != shape:
            raise TypeError(
                f"layout extents {layout.extents} do not match array shape {shape}"
            )
        # zero-copy encode paths: identity layouts never scatter
        if isinstance(layout, LayoutRight):
            codomain = dense.reshape(-1)
        elif isinstance(layout, LayoutLeft):
            codomain = dense.permute(tuple(range(dense.ndim - 1, -1, -1))).reshape(-1)
        else:
            offs = layout.offsets_dense(dense.device).reshape(-1)
            codomain = dense.new_zeros((layout.required_span_size(),))
            # Non-unique layouts: later writes win (C++: UB; we pick determinism).
            codomain[offs] = dense.reshape(-1)
        return MdSpan(accessor.from_codomain(codomain), layout, accessor)

    @staticmethod
    def over(buffer, layout: LayoutMapping, accessor: Accessor | None = None) -> "MdSpan":
        """View EXISTING storage (the paper's primary use: interpret memory)."""
        accessor = accessor if accessor is not None else BasicAccessor(
            buffer.dtype if isinstance(buffer, torch.Tensor) else torch.float32
        )
        return MdSpan(buffer, layout, accessor)

    def __repr__(self) -> str:  # pragma: no cover
        return (
            f"MdSpan(extents={self.extents}, layout={type(self.layout).__name__}, "
            f"accessor={type(self.accessor).__name__})"
        )


def mdspan(data, *extent_spec, accessor: Accessor | None = None, device=None) -> MdSpan:
    """The convenience alias mirroring ``std::mdspan<T, E0, E1, ...>(ptr, dyn...)``:
    interpret a flat buffer as a multi-dimensional entity (row-major, all
    extents given here as static)."""
    if any(isinstance(e, _DynamicExtent) for e in extent_spec):
        raise TypeError(
            "pass dynamic sizes by constructing Extents explicitly: "
            "MdSpan.over(buf, LayoutRight(Extents.of(...)(sizes)))"
        )
    data = as_tensor(data, device=device)
    ext = Extents.make(extent_spec)
    if ext.size() > data.numel():
        raise ValueError(f"buffer of {data.numel()} elements too small for {ext}")
    acc = accessor if accessor is not None else BasicAccessor(data.dtype)
    return MdSpan(data.reshape(-1), LayoutRight(ext), acc)
