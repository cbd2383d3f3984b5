"""CountingAccessor: the paper's accessor hook used FOR observability.

Port of ``repro.core.instrument``. ``CountingAccessor`` wraps any accessor of
``core.accessors`` and forwards every operation unchanged while tallying
loads/stores and the representation-true bytes behind them (each wrapped
accessor prices its own ``bytes_for_offsets``; the wrapper never looks inside
buffers). Because accessors see only flat codomain offsets, the wrapper
composes with any layout. ``counted_paged_decode`` drives LayoutPaged's
offset formula

    ((page * Hkv + head) * page_size + slot) * D + d

through a counted accessor and replays the port's plain paged decode
(``kernels.paged_attention.paged_decode_attention_torch``) on the gathered
values: the same output as the decode kernel, plus a measured bytes-moved
figure. Page skipping mirrors the kernel: only pages with
``j * page_size < context_len`` are gathered. int4 pools count through
``Int4SplitHalfAccessor`` (``kvquant.PagedQuantSpec.as_flat_accessor``), so
f32, int8 and int4 pools are all measurable.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from .accessors import Accessor, as_tensor


@dataclasses.dataclass
class TrafficTally:
    """Running totals of accessor traffic (host-side ints, O(1) memory)."""

    loads: int = 0          # offsets read
    stores: int = 0         # offsets written
    bytes_loaded: int = 0   # storage bytes behind the reads
    bytes_stored: int = 0   # storage bytes behind the writes

    @property
    def bytes_moved(self) -> int:
        return self.bytes_loaded + self.bytes_stored

    def reset(self) -> None:
        self.loads = self.stores = 0
        self.bytes_loaded = self.bytes_stored = 0


class CountingAccessor(Accessor):
    """Wrap ``inner``, forwarding everything and counting traffic into
    ``tally``. Offsets are counted at call time (their count, and the bytes
    the inner accessor prices for them), so this is an instrumentation twin
    for the plain paths, not a hot-path accessor."""

    def __init__(self, inner: Accessor, tally: TrafficTally | None = None):
        self.inner = inner
        self.tally = tally if tally is not None else TrafficTally()

    @property
    def element_type(self) -> Any:  # type: ignore[override]
        return self.inner.element_type

    def storage_dtype(self):
        return self.inner.storage_dtype()

    def alloc(self, span_size: int, device=None):
        return self.inner.alloc(span_size, device)

    def from_codomain(self, dense, device=None):
        return self.inner.from_codomain(dense, device)

    def access(self, buffers, i):
        self.tally.loads += int(np.size(i) if not isinstance(i, torch.Tensor) else i.numel())
        self.tally.bytes_loaded += self.inner.bytes_for_offsets(i)
        return self.inner.access(buffers, i)

    def store(self, buffers, i, value):
        self.tally.stores += int(np.size(i) if not isinstance(i, torch.Tensor) else i.numel())
        self.tally.bytes_stored += self.inner.bytes_for_offsets(i)
        return self.inner.store(buffers, i, value)

    def decay(self, buffers):
        return self.inner.decay(buffers)

    @property
    def offset_policy(self) -> "Accessor":
        # rebased views keep counting into the SAME tally
        return self

    def offset(self, buffers, i):
        return self.inner.offset(buffers, i)

    def bytes_for_offsets(self, i) -> int:
        return self.inner.bytes_for_offsets(i)


def flat_pool_offsets(phys_pages, hkv: int, page_size: int, head_dim: int,
                      device=None) -> torch.Tensor:
    """Flat codomain offsets of whole pages: LayoutPaged's offset formula
    vectorized over (n_pages, Hkv, page_size, D), int64. ``phys_pages`` is a
    1-D array of physical page ids (a tensor stays on its device; anything
    else goes to ``device``)."""
    p = as_tensor(phys_pages, torch.int64, device)
    ar = lambda n: torch.arange(n, dtype=torch.int64, device=p.device)
    h, s, d = ar(hkv), ar(page_size), ar(head_dim)
    return (
        ((p[:, None, None, None] * hkv + h[None, :, None, None]) * page_size
         + s[None, None, :, None]) * head_dim + d[None, None, None, :]
    )


def counted_paged_decode(
    q: torch.Tensor,
    k_buffers,
    v_buffers,
    accessor: CountingAccessor,
    block_tables,
    context_lens,
    *,
    pool_shape,
    scale: float | None = None,
):
    """Paged GQA decode through a counted accessor over the FLAT pool codomain.

    q: (B, Hq, 1, D); k_buffers/v_buffers: ``accessor``-encoded buffers of the
    flattened (num_pages, Hkv, page_size, D) pool (f32: the pool reshaped to
    1-D; intN: ``PagedQuantSpec.as_flat_accessor`` buffers); block_tables:
    (B, max_pages); context_lens: (B,); pool_shape: the 4-tuple above.
    Returns (out, tally): ``out`` (B, Hq, 1, D) in q's dtype, what the plain
    paged decode gives on the equivalent dense pool, and the accessor's
    tally after this call.

    Each row gathers its live pages (the ones the kernel reads) through the
    accessor, in table order, and runs the port's plain paged decode over
    them as a pool of its own; rows of length 0 give exact zeros.
    """
    from repro_torch.kernels.paged_attention import paged_decode_attention_torch

    b, hq, tq, d = q.shape
    _, hkv, page_size, d_pool = pool_shape
    if tq != 1 or hq % hkv or d != d_pool:
        raise ValueError(f"q {tuple(q.shape)} does not fit pool {tuple(pool_shape)}")
    tables = np.asarray(block_tables.cpu() if isinstance(block_tables, torch.Tensor)
                        else block_tables)
    lens = np.asarray(context_lens.cpu() if isinstance(context_lens, torch.Tensor)
                      else context_lens)
    out = torch.zeros_like(q)
    for row in range(b):
        n_tok = int(lens[row])
        if n_tok <= 0:
            continue  # kernel parity: fully-masked rows output exact zeros
        n_live = -(-n_tok // page_size)
        offs = flat_pool_offsets(tables[row, :n_live], hkv, page_size, d, device=q.device)
        k = accessor.access(k_buffers, offs).reshape(n_live, hkv, page_size, d)
        v = accessor.access(v_buffers, offs).reshape(n_live, hkv, page_size, d)
        own = torch.arange(n_live, dtype=torch.int32, device=q.device)[None, :]
        n = torch.tensor([n_tok], dtype=torch.int32, device=q.device)
        out[row] = paged_decode_attention_torch(q[row:row + 1], k, v, own, n, scale=scale)[0]
    return out, accessor.tally
