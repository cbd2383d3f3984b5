"""The mdspan views of the port's paged KV cache against the JAX cache's.

``layout_for`` (a slot's LayoutPaged, with the pages other holders share),
``chunk_view`` (the chunk as a submdspan of it) and ``dense_view`` (the
generic gather through its offsets) must equal the JAX cache's on the same
allocator trace: allocation, prefix adoption, copy-on-write and free, as in
tests/test_prefix_sharing.py and tests/test_submdspan_paged.py, over f32,
int8 and int4 pools holding the same values.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine.cache import PagedKVCache as JaxCache
from repro.serving.engine.kvquant import KV_DTYPES as JAX_KV_DTYPES
from repro_torch.core import LayoutPaged
from repro_torch.serving.engine.cache import PagedKVCache
from repro_torch.serving.engine.kvquant import KV_DTYPES

HKV, DH, PS, NUM_PAGES = 2, 4, 4, 10


@dataclasses.dataclass
class FakeCfg:
    n_kv_heads: int = HKV
    head_dim: int = DH


class JaxModel:
    cfg = FakeCfg()

    def init_paged_cache(self, num_pages, page_size, kv_spec=None):
        if kv_spec is not None:
            dq = kv_spec.packed_dim(DH)
            return [{k: {"q": jnp.zeros((1, num_pages, HKV, page_size, dq), jnp.int8),
                         "scale": jnp.zeros((1, num_pages, HKV), jnp.float32)}
                     for k in ("k", "v")}]
        shape = (1, num_pages, HKV, page_size, DH)
        return [{"k": jnp.zeros(shape), "v": jnp.zeros(shape)}]


class TorchModel:
    cfg = FakeCfg()
    device = torch.device("cpu")

    def init_paged_cache(self, num_pages, page_size, kv_spec=None):
        if kv_spec is not None:
            dq = kv_spec.packed_dim(DH)
            return [{k: {"q": torch.zeros((1, num_pages, HKV, page_size, dq), dtype=torch.int8),
                         "scale": torch.zeros((1, num_pages, HKV))}
                     for k in ("k", "v")}]
        shape = (1, num_pages, HKV, page_size, DH)
        return [{"k": torch.zeros(shape), "v": torch.zeros(shape)}]


def make_caches(kv_dtype="f32"):
    kw = dict(num_pages=NUM_PAGES, page_size=PS, max_batch=2, max_pages_per_seq=6,
              kv_dtype=kv_dtype)
    return PagedKVCache(TorchModel(), **kw), JaxCache(JaxModel(), **kw)


def assert_same_layout(got: LayoutPaged, want) -> None:
    for f in ("block_table", "shared_pages", "pos_offset", "num_pages", "page_size"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.extents.sizes == want.extents.sizes
    assert got.is_unique() == want.is_unique()
    np.testing.assert_array_equal(got.offsets_dense("cpu").numpy(),
                                  np.asarray(want.offsets_dense()))


CHUNKS = [(0, 4), (4, 10), (3, 7), (9, 10), (0, 8), (8, 10)]


def test_layout_for_and_chunk_views_follow_the_allocator_trace():
    """test_prefix_sharing.py's trace: a donor, a sharer adopting all three
    pages, a CoW of the sharer's partial page, the donor freed."""
    tc, jc = make_caches()
    toks = list(range(10))

    def check(slots):
        for slot in slots:
            assert tc.pages_of[slot] == jc.pages_of[slot]
            assert tc.shared_pages_of(slot) == jc.shared_pages_of(slot)
            assert_same_layout(tc.layout_for(slot), jc.layout_for(slot))
            for a, b in [(0, 8), (3, 7), (8, 10)]:
                assert_same_layout(tc.chunk_view(slot, a, b).layout,
                                   jc.chunk_view(slot, a, b).layout)

    for c in (tc, jc):
        c.allocate(0, 3, tokens=toks)
    check([0])
    assert tc.layout_for(0).is_unique()
    for c in (tc, jc):
        c.allocate(1, 3, tokens=toks)
    check([0, 1])
    assert not tc.layout_for(1).is_unique()
    assert tc.layout_for(1).shared_pages == tuple(tc.pages_of[0])
    for c in (tc, jc):
        c.lens[1] = 10
        assert c.cow_page(1)
    check([0, 1])
    assert tc.chunk_view(1, 8, 10).layout.is_unique()
    assert not tc.chunk_view(1, 0, 8).layout.is_unique()
    for c in (tc, jc):
        c.free_slot(0)
    check([1])
    assert tc.layout_for(1).is_unique()


@pytest.mark.parametrize("kv_dtype", ["f32", "int8", "int4"])
def test_dense_and_chunk_views_read_the_same_values(kv_dtype):
    tc, jc = make_caches(kv_dtype)
    for c in (tc, jc):
        c.allocate(0, 3, tokens=list(range(10)))
        c.lens[0] = 10
    rng = np.random.default_rng(0)
    vals = {k: rng.standard_normal((1, NUM_PAGES, HKV, PS, DH)).astype(np.float32)
            for k in ("k", "v")}
    if KV_DTYPES[kv_dtype] is None:
        tc.pools = [{k: torch.from_numpy(v) for k, v in vals.items()}]
        jc.pools = [{k: jnp.asarray(v) for k, v in vals.items()}]
    else:
        tc.pools = [{k: KV_DTYPES[kv_dtype].encode_pages(torch.from_numpy(v))
                     for k, v in vals.items()}]
        jc.pools = [{k: JAX_KV_DTYPES[kv_dtype].encode_pages(jnp.asarray(v))
                     for k, v in vals.items()}]
    got, want = tc.dense_view(0), jc.dense_view(0)
    for g, w in zip(got, want):
        assert tuple(g.shape) == (HKV, 10, DH)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    for a, b in CHUNKS:
        chunk = tc.chunk_view(0, a, b)
        np.testing.assert_array_equal(chunk.to_dense()[0].numpy(),
                                      np.asarray(jc.chunk_view(0, a, b).to_dense()[0]))
        np.testing.assert_array_equal(chunk.to_dense()[0].numpy(), got[0][:, a:b].numpy())
