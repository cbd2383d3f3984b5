"""Extents: the multi-index domain of an mdspan, mixing static and dynamic sizes.

Port of ``repro.core.extents`` (pure Python, the same semantics). Paper
mapping (mdspan §Extents Class Template): C++ ``extents<20, dynamic_extent>``
binds one extent into the *type* and defers the other to the constructor.
The port keeps the staticness flag as data, and the CUDA side gives it its
C++ meaning: a kernel may specialize on static extents (template parameters,
as ``kernels/csrc/paper_suite.cu``'s static TinyMatrixSum takes J and K) and
must stay generic over dynamic ones (runtime ints) — the mechanism behind
the paper's Fig. 5.
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Iterator, Sequence, Union


class _DynamicExtent:
    """Sentinel mirroring C++ ``std::dynamic_extent``. Singleton."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "dynamic_extent"

    def __reduce__(self):
        return (_DynamicExtent, ())


#: The sentinel users write in extent lists, e.g. ``Extents(20, dynamic_extent)``.
dynamic_extent = _DynamicExtent()

ExtentLike = Union[int, _DynamicExtent]


@dataclasses.dataclass(frozen=True)
class Extents:
    """A rank-R multi-index domain with per-rank static/dynamic marking.

    ``statics[r]`` is the compile-time extent (int) or None when rank r is dynamic.
    ``sizes[r]`` is the bound size of every rank (static ranks repeat their static
    value). Construction mirrors C++: static extents come from the "type" (the
    ``statics`` tuple), dynamic ones from constructor arguments, in order.

    >>> e = Extents.of(20, dynamic_extent)(40)
    >>> e.extent(0), e.extent(1), e.static_extent(1)
    (20, 40, None)
    """

    statics: tuple  # tuple[int | None, ...]
    sizes: tuple    # tuple[int, ...]

    # -- constructors ------------------------------------------------------------
    @staticmethod
    def of(*spec: ExtentLike) -> "_ExtentsFactory":
        """Partially-applied constructor mirroring the C++ template-parameter split."""
        return _ExtentsFactory(tuple(spec))

    @staticmethod
    def make(spec: Sequence[ExtentLike], dynamic_sizes: Sequence[int] = ()) -> "Extents":
        statics = tuple(None if isinstance(s, _DynamicExtent) else int(s) for s in spec)
        dyn = list(dynamic_sizes)
        sizes = []
        for s in statics:
            if s is None:
                if not dyn:
                    raise TypeError(
                        f"Extents{tuple(spec)} needs {sum(x is None for x in statics)} "
                        f"dynamic size(s), got {len(dynamic_sizes)}"
                    )
                sizes.append(int(dyn.pop(0)))
            else:
                if s < 0:
                    raise ValueError(f"negative static extent {s}")
                sizes.append(s)
        if dyn:
            raise TypeError(f"too many dynamic sizes for spec {tuple(spec)}")
        if any(x < 0 for x in sizes):
            raise ValueError(f"negative extent in {sizes}")
        return Extents(statics, tuple(sizes))

    @staticmethod
    def fully_static(*sizes: int) -> "Extents":
        if any(int(s) < 0 for s in sizes):
            raise ValueError(f"negative extent in {sizes}")
        return Extents(tuple(int(s) for s in sizes), tuple(int(s) for s in sizes))

    @staticmethod
    def fully_dynamic(*sizes: int) -> "Extents":
        if any(int(s) < 0 for s in sizes):
            raise ValueError(f"negative extent in {sizes}")
        return Extents(tuple(None for _ in sizes), tuple(int(s) for s in sizes))

    # -- observers (paper Table I names) ------------------------------------------
    @property
    def rank(self) -> int:
        return len(self.statics)

    @property
    def rank_dynamic(self) -> int:
        return sum(1 for s in self.statics if s is None)

    def extent(self, r: int) -> int:
        return self.sizes[r]

    def static_extent(self, r: int):
        """The compile-time extent of rank r, or None (C++: dynamic_extent)."""
        return self.statics[r]

    def is_static(self, r: int) -> bool:
        return self.statics[r] is not None

    @property
    def is_fully_static(self) -> bool:
        return all(s is not None for s in self.statics)

    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n

    # -- utilities ----------------------------------------------------------------
    def as_shape(self) -> tuple:
        return self.sizes

    def with_extent(self, r: int, size: int, static: bool = False) -> "Extents":
        statics = list(self.statics)
        sizes = list(self.sizes)
        statics[r] = int(size) if static else None
        sizes[r] = int(size)
        return Extents(tuple(statics), tuple(sizes))

    def indices(self) -> Iterator[tuple]:
        """Iterate the whole multi-index domain (test-sized extents only)."""
        return itertools.product(*(range(s) for s in self.sizes))

    def contains(self, idx: Sequence[int]) -> bool:
        return len(idx) == self.rank and all(
            0 <= i < s for i, s in zip(idx, self.sizes)
        )

    def __repr__(self) -> str:
        parts = [
            (str(st) if st is not None else f"dyn({sz})")
            for st, sz in zip(self.statics, self.sizes)
        ]
        return f"Extents<{', '.join(parts)}>"


@dataclasses.dataclass(frozen=True)
class _ExtentsFactory:
    spec: tuple

    def __call__(self, *dynamic_sizes: int) -> Extents:
        return Extents.make(self.spec, dynamic_sizes)
