"""repro_torch.core against the JAX reference's repro.core, on the CPU.

Every case builds the same object in both packages from the same arguments
(the two share every public name) and compares what they compute: extents
algebra, each layout's offsets and Table I observers (LayoutPaged after
fork, fork_group, permute_rows and cow_slice included), the LayoutError
gates, to_dense / scatter_from_dense per layout, submdspan (the paged chunk
views included) and the algorithms. Offsets compare as values: the port's
are int64, the reference's int32. Cases follow tests/test_extents.py,
test_layouts.py, test_mdspan.py, test_algorithms.py and
test_submdspan_paged.py.
"""
import pickle

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
try:  # only the property test needs hypothesis; the rest run without it
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = None

import repro.core as J
import repro_torch.core as T
from repro_torch.core import algorithms as talg
from repro.core import algorithms as jalg

PKGS = {"jax": J, "torch": T}
DT = {"jax": jnp.float32, "torch": torch.float32}


def arr(pkg, x):
    """A numpy array as the package's array type (CPU for the port)."""
    return jnp.asarray(x) if pkg == "jax" else torch.from_numpy(np.ascontiguousarray(x))


def npy(a) -> np.ndarray:
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def offsets(pkg, layout) -> np.ndarray:
    return npy(layout.offsets_dense() if pkg == "jax" else layout.offsets_dense("cpu"))


# =====================================================================================
# extents
# =====================================================================================
EXTENT_CASES = {
    "static_dynamic_mix": lambda c: c.Extents.of(20, c.dynamic_extent)(40),
    "fully_static": lambda c: c.Extents.fully_static(3, 4, 5),
    "fully_dynamic": lambda c: c.Extents.fully_dynamic(3, 4, 5),
    "with_extent": lambda c: c.Extents.of(8, c.dynamic_extent)(16).with_extent(1, 32, static=True),
    "with_extent_dynamic": lambda c: c.Extents.fully_static(2, 3).with_extent(0, 5),
    "rank0": lambda c: c.Extents.make(()),
    "zero_size": lambda c: c.Extents.fully_dynamic(2, 0),
}


@pytest.mark.parametrize("case", sorted(EXTENT_CASES))
def test_extents_algebra_matches_reference(case):
    got, want = (EXTENT_CASES[case](PKGS[p]) for p in ("torch", "jax"))
    assert (got.statics, got.sizes) == (want.statics, want.sizes)
    assert (got.rank, got.rank_dynamic, got.is_fully_static, got.size(), repr(got)) == (
        want.rank, want.rank_dynamic, want.is_fully_static, want.size(), repr(want))
    assert sorted(got.indices()) == sorted(want.indices())
    for r in range(got.rank):
        assert (got.extent(r), got.static_extent(r), got.is_static(r)) == (
            want.extent(r), want.static_extent(r), want.is_static(r))
    for idx in [(0,) * got.rank, tuple(s - 1 for s in got.sizes), tuple(got.sizes), (0,)]:
        assert got.contains(idx) == want.contains(idx)


EXTENT_ERRORS = {
    "missing_dynamic": lambda c: c.Extents.of(20, c.dynamic_extent)(),
    "extra_dynamic": lambda c: c.Extents.of(20, c.dynamic_extent)(40, 50),
    "negative_static": lambda c: c.Extents.fully_static(-1, 2),
    "negative_dynamic": lambda c: c.Extents.of(c.dynamic_extent)(-3),
    "negative_fully_dynamic": lambda c: c.Extents.fully_dynamic(4, -1),
}


@pytest.mark.parametrize("case", sorted(EXTENT_ERRORS))
def test_extents_errors_match_reference(case):
    raised = {}
    for p in ("jax", "torch"):
        with pytest.raises((TypeError, ValueError)) as e:
            EXTENT_ERRORS[case](PKGS[p])
        raised[p] = type(e.value).__name__
    assert raised["torch"] == raised["jax"]


def test_dynamic_extent_is_a_pickling_singleton():
    assert pickle.loads(pickle.dumps(T.dynamic_extent)) is T.dynamic_extent
    assert T.Extents.of(T.dynamic_extent)(3).statics == (None,)


# =====================================================================================
# layouts: offsets and observers, case for case
# =====================================================================================
def _scattered(c, shared=(), host=()):
    # 2 sequences x 3 pages out of a 9-page pool, deliberately out of order
    return c.LayoutPaged(c.Extents.fully_dynamic(2, 2, 12, 4), ((5, 2, 8), (7, 1, 3)), 4, 9,
                         shared, host_pages=host)


LAYOUT_CASES = {
    "right_1d": lambda c: c.LayoutRight(c.Extents.fully_dynamic(7)),
    "right_3d": lambda c: c.LayoutRight(c.Extents.fully_dynamic(2, 3, 4)),
    "left_3d": lambda c: c.LayoutLeft(c.Extents.fully_dynamic(2, 3, 4)),
    "left_static": lambda c: c.LayoutLeft(c.Extents.fully_static(5, 6)),
    "stride_ld": lambda c: c.LayoutStride(c.Extents.fully_dynamic(3, 4), (6, 1), 2),
    "stride_aliasing": lambda c: c.LayoutStride(c.Extents.fully_dynamic(2, 2), (1, 1), 1),
    "stride_contiguous": lambda c: c.LayoutStride(c.Extents.fully_dynamic(3, 4), (1, 3), 0),
    "symmetric_4": lambda c: c.LayoutSymmetricPacked(c.Extents.fully_dynamic(4, 4)),
    "symmetric_1": lambda c: c.LayoutSymmetricPacked(c.Extents.fully_dynamic(1, 1)),
    "tiled_padded": lambda c: c.LayoutTiledTPU(c.Extents.fully_dynamic(5, 6), tile=(2, 4)),
    "tiled_exact": lambda c: c.LayoutTiledTPU(c.Extents.fully_dynamic(4, 8), tile=(2, 4)),
    "tiled_3d": lambda c: c.LayoutTiledTPU(c.Extents.fully_dynamic(2, 3, 5), tile=(2, 4)),
    "paged": _scattered,
    "paged_shared": lambda c: _scattered(c, shared=(5, 2)),
    "paged_host": lambda c: _scattered(c, host=(2, 7)),
    "paged_dense": lambda c: c.LayoutPaged.dense(2, 2, 8, 3, 4),
    "paged_fork": lambda c: _scattered(c).fork(0, (4,)),
    "paged_fork_shared": lambda c: _scattered(c, shared=(5,)).fork(1),
    "paged_fork_group": lambda c: _scattered(c).fork_group(1, 2, [(4,), (6,)]),
    "paged_permute": lambda c: _scattered(c).fork(0, (4,)).permute_rows((2, 0, 1)),
    "paged_cow": lambda c: _scattered(c).fork(0, (4,)).cow_slice(2, 1, 6),
    "paged_cow_resolves": lambda c: _scattered(c, shared=(5,), host=(0, 6)).fork(0)
    .cow_slice(2, 0, 0).cow_slice(2, 1, 4).cow_slice(2, 2, 6),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_matches_reference(case):
    got, want = LAYOUT_CASES[case](T), LAYOUT_CASES[case](J)
    np.testing.assert_array_equal(offsets("torch", got), offsets("jax", want))
    assert offsets("torch", got).dtype == np.int64
    for obs in ("required_span_size", "is_unique", "is_contiguous", "is_strided"):
        assert getattr(got, obs)() == getattr(want, obs)(), obs
    for obs in ("is_always_unique", "is_always_contiguous", "is_always_strided"):
        assert getattr(type(got), obs)() == getattr(type(want), obs)(), obs
    if want.is_strided():
        assert [got.stride(r) for r in range(got.rank)] == [
            want.stride(r) for r in range(want.rank)]
    # scalar calls agree with the dense offsets
    idx = tuple(s - 1 for s in got.extents.sizes)
    assert got(*idx) == int(want(*idx))
    if isinstance(want, J.LayoutPaged):
        for f in ("block_table", "shared_pages", "host_pages", "pos_offset", "num_pages"):
            assert getattr(got, f) == getattr(want, f), f
        assert got.pool_shape() == want.pool_shape()
        assert got.extents.sizes == want.extents.sizes
        for s, h, p in [(0, 0, 0), (got.extents.extent(0) - 1, 1, got.extents.extent(2) - 1)]:
            assert got.space_for(s, h, p, 0).value == want.space_for(s, h, p, 0).value
        for o in (0, 31, got.required_span_size() - 1):
            assert got.space_for_offset(o).value == want.space_for_offset(o).value


def _check_laws(layout):
    """The Table I laws of the reference's test_layouts.py, on the port."""
    offs = offsets("torch", layout).reshape(-1)
    span = layout.required_span_size()
    assert offs.min() >= 0 and offs.max() < span
    if layout.is_unique():
        assert len(np.unique(offs)) == layout.extents.size()
    if layout.is_contiguous():
        assert set(offs.tolist()) == set(range(span))
    if layout.is_strided():
        ext = layout.extents
        for idx in ext.indices():
            for r in range(ext.rank):
                nxt = list(idx)
                nxt[r] += 1
                if nxt[r] < ext.extent(r):
                    assert layout(*nxt) - layout(*idx) == layout.stride(r)


@pytest.mark.parametrize("case", sorted(LAYOUT_CASES))
def test_layout_laws_hold_on_the_port(case):
    _check_laws(LAYOUT_CASES[case](T))


if given is not None:
    @settings(max_examples=25, deadline=None)
    @given(st.lists(st.integers(1, 5), min_size=1, max_size=3), st.integers(0, 3), st.data())
    def test_layout_stride_laws_property(sz, offset, data):
        strides = tuple(data.draw(st.integers(1, 40), label=f"stride{r}")
                        for r in range(len(sz)))
        lay = T.LayoutStride(T.Extents.fully_dynamic(*sz), strides, offset)
        _check_laws(lay)
        for order in (T.LayoutRight, T.LayoutLeft):
            _check_laws(order(T.Extents.fully_dynamic(*sz)))


LAYOUT_ERRORS = {
    "symmetric_stride": lambda c: c.LayoutSymmetricPacked(c.Extents.fully_dynamic(3, 3)).stride(0),
    "tiled_stride": lambda c: c.LayoutTiledTPU(c.Extents.fully_dynamic(3, 3)).stride(1),
    "paged_stride": lambda c: _scattered(c).stride(0),
    "symmetric_not_square": lambda c: c.LayoutSymmetricPacked(c.Extents.fully_dynamic(2, 3)),
    "tiled_rank1": lambda c: c.LayoutTiledTPU(c.Extents.fully_dynamic(4)),
    "stride_count": lambda c: c.LayoutStride(c.Extents.fully_dynamic(2, 2), (1,)),
    "paged_rank3": lambda c: c.LayoutPaged(c.Extents.fully_dynamic(1, 2, 4), ((1,),), 4, 2),
    "paged_row_width": lambda c: c.LayoutPaged(c.Extents.fully_dynamic(1, 1, 8, 2), ((1,),), 4, 3),
    "paged_page_range": lambda c: c.LayoutPaged(c.Extents.fully_dynamic(1, 1, 4, 2), ((3,),), 4, 3),
    "paged_pos_offset": lambda c: c.LayoutPaged(c.Extents.fully_dynamic(1, 1, 4, 2), ((1, 2),),
                                                4, 3, pos_offset=4),
    "paged_fork_seq": lambda c: _scattered(c).fork(2),
    "paged_fork_tail": lambda c: _scattered(c).fork(0, (1, 2, 3, 4)),
    "paged_fork_group_n": lambda c: _scattered(c).fork_group(0, 0),
    "paged_permute": lambda c: _scattered(c).permute_rows((0, 0)),
    "paged_cow_page": lambda c: _scattered(c).cow_slice(0, 3, 4),
    "paged_space_offset": lambda c: _scattered(c).space_for_offset(9 * 2 * 4 * 4),
}


@pytest.mark.parametrize("case", sorted(LAYOUT_ERRORS))
def test_layout_errors_match_reference(case):
    raised = {}
    for p in ("jax", "torch"):
        with pytest.raises((TypeError, ValueError)) as e:
            LAYOUT_ERRORS[case](PKGS[p])
        raised[p] = type(e.value).__name__
    assert raised["torch"] == raised["jax"]


# =====================================================================================
# mdspan: to_dense / scatter_from_dense per layout
# =====================================================================================
DENSE_CASES = sorted(k for k in LAYOUT_CASES if not k.startswith("stride_alias"))


@pytest.mark.parametrize("case", DENSE_CASES)
def test_from_dense_to_dense_scatter_match_reference(case):
    rng = np.random.default_rng(len(case))
    lays = {p: LAYOUT_CASES[case](PKGS[p]) for p in PKGS}
    shape = lays["torch"].extents.sizes
    x = rng.standard_normal(shape).astype(np.float32)
    if not lays["jax"].is_unique():
        # aliased indices must carry one value (which write lands is unspecified)
        base = rng.standard_normal(lays["torch"].required_span_size()).astype(np.float32)
        x = base[offsets("torch", lays["torch"])]
    spans = {p: PKGS[p].MdSpan.from_dense(arr(p, x), layout=lays[p]) for p in PKGS}
    np.testing.assert_array_equal(npy(spans["torch"].codomain()), npy(spans["jax"].codomain()))
    np.testing.assert_array_equal(npy(spans["torch"].to_dense()), npy(spans["jax"].to_dense()))
    y = rng.standard_normal(shape).astype(np.float32)
    if spans["jax"].is_unique():
        out = {p: spans[p].scatter_from_dense(arr(p, y)) for p in PKGS}
        np.testing.assert_array_equal(npy(out["torch"].buffers), npy(out["jax"].buffers))
        np.testing.assert_array_equal(npy(out["torch"].to_dense()), y)
    else:
        for p in PKGS:
            with pytest.raises(PKGS[p].LayoutError):
                spans[p].scatter_from_dense(arr(p, y))
        # an accumulating accessor makes the same store well defined
        out = {}
        for p in PKGS:
            acc = PKGS[p].AccumulateAccessor(DT[p])
            out[p] = PKGS[p].MdSpan(spans[p].buffers, lays[p], acc).scatter_from_dense(arr(p, y))
        np.testing.assert_allclose(npy(out["torch"].buffers), npy(out["jax"].buffers),
                                   rtol=1e-6, atol=1e-6)


def test_to_dense_fast_paths_are_views():
    x = torch.arange(24, dtype=torch.float32).reshape(2, 3, 4)
    for lay in (T.LayoutRight, T.LayoutLeft):
        m = T.MdSpan.from_dense(x, layout=lay(T.Extents.fully_dynamic(2, 3, 4)))
        d = m.to_dense()
        assert d.data_ptr() == m.buffers.data_ptr() and torch.equal(d, x)
    sub = T.submdspan(T.mdspan(torch.arange(24.0), 4, 6), (1, 3), T.all_)
    d = sub.to_dense()
    assert d.untyped_storage().data_ptr() == sub.buffers.untyped_storage().data_ptr()
    np.testing.assert_array_equal(sub.to_dense().numpy(), np.arange(24.0).reshape(4, 6)[1:3])


def test_paper_example_matrix_interpretation():
    """'interpret memory starting at data as a 20 x 40 matrix' (both packages)."""
    for p, c in PKGS.items():
        m = c.mdspan(arr(p, np.arange(800, dtype=np.float32)), 20, 40)
        assert float(m(10, 5)) == 405.0
        m2 = m.set((10, 5), m(10, 5) + 3.14)
        assert abs(float(m2(10, 5)) - 408.14) < 1e-4 and float(m2(0, 38)) == 38.0
        assert float(m(10, 5)) == 405.0  # the functional store left m alone


def test_mdspan_constructors_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.MdSpan.from_dense(np.zeros((2, 3), np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.mdspan(np.zeros(6, np.float32), 2, 3)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        T.LayoutRight(T.Extents.fully_dynamic(2)).offsets_dense()
    m = T.MdSpan.from_dense(np.zeros((2, 3), np.float32), device="cpu")
    assert m.device.type == "cpu"
    assert T.MdSpan.from_dense(torch.zeros(2, 3)).device.type == "cpu"  # a tensor stays put


def test_quantized_mdspan_view_matches_reference():
    x = np.linspace(-2, 2, 32, dtype=np.float32).reshape(4, 8)
    spans = {p: PKGS[p].MdSpan.from_dense(arr(p, x), accessor=PKGS[p].QuantizedAccessor(
        DT[p], bits=8, block=8)) for p in PKGS}
    np.testing.assert_array_equal(npy(spans["torch"].buffers["q"]), npy(spans["jax"].buffers["q"]))
    np.testing.assert_array_equal(npy(spans["torch"].to_dense()), npy(spans["jax"].to_dense()))


# =====================================================================================
# submdspan
# =====================================================================================
SUB_CASES = {
    "paper_subspan": ((3, 4, 5, 20), (2, "all", (2, 4), 0)),
    "rows": ((4, 6), ((1, 3), "all")),
    "cols": ((4, 6), ("all", (1, 4))),
    "point_rank": ((3, 4, 5), (1, "all", "all")),
    "scalar": ((3, 4), (2, 1)),
}


def _spec(c, spec):
    return tuple(c.all_ if s == "all" else s for s in spec)


@pytest.mark.parametrize("case", sorted(SUB_CASES))
def test_submdspan_matches_reference(case):
    shape, spec = SUB_CASES[case]
    data = np.arange(int(np.prod(shape)), dtype=np.float32)
    subs = {p: c.submdspan(c.mdspan(arr(p, data), *shape), *_spec(c, spec))
            for p, c in PKGS.items()}
    got, want = subs["torch"], subs["jax"]
    assert got.shape == want.shape and got.extents.statics == want.extents.statics
    assert (got.layout.strides, got.layout.offset) == (want.layout.strides, want.layout.offset)
    np.testing.assert_array_equal(npy(got.to_dense()), npy(want.to_dense()))
    assert got.buffers.data_ptr() == subs["torch"].buffers.data_ptr()  # shares the buffer


def test_submdspan_composes_and_keeps_static_extents():
    t = T.mdspan(torch.arange(60, dtype=torch.float32), 3, 4, 5)
    s2 = T.submdspan(T.submdspan(t, 1, T.all_, T.all_), (1, 3), 2)
    assert [float(s2(i)) for i in range(2)] == [float(t(1, i + 1, 2)) for i in range(2)]
    st_ = T.MdSpan.from_dense(torch.zeros(4, 6), static=True)
    sub = T.submdspan(st_, T.all_, (1, 4))
    assert sub.extents.static_extent(0) == 4 and sub.extents.static_extent(1) is None
    assert T.submdspan(t, T.all_, (0, 2), T.all_).buffers is t.buffers
    with pytest.raises(IndexError):
        T.submdspan(T.mdspan(torch.zeros(12), 3, 4), (0, 5), T.all_)
    with pytest.raises(IndexError):
        T.submdspan(T.mdspan(torch.zeros(12), 3, 4), 3, T.all_)
    with pytest.raises(TypeError):
        T.submdspan(T.mdspan(torch.zeros(12), 3, 4), T.all_)


def _paged_span(p, layout):
    return PKGS[p].MdSpan.over(arr(p, np.arange(layout.required_span_size(), dtype=np.float32)),
                               layout)


@pytest.mark.parametrize("a,b", [(0, 12), (0, 5), (2, 7), (4, 8), (3, 4), (9, 12)])
@pytest.mark.parametrize("shared", [(), (5, 2)])
def test_paged_chunk_views_match_reference(a, b, shared):
    subs = {}
    for p, c in PKGS.items():
        span = _paged_span(p, _scattered(c, shared=shared))
        subs[p] = c.submdspan(span, c.all_, c.all_, (a, b), c.all_)
    got, want = subs["torch"].layout, subs["jax"].layout
    assert isinstance(got, T.LayoutPaged)
    for f in ("block_table", "shared_pages", "pos_offset", "num_pages", "page_size"):
        assert getattr(got, f) == getattr(want, f), f
    assert got.extents.sizes == want.extents.sizes and got.is_unique() == want.is_unique()
    np.testing.assert_array_equal(offsets("torch", got), offsets("jax", want))
    np.testing.assert_array_equal(npy(subs["torch"].to_dense()), npy(subs["jax"].to_dense()))
    parent = _scattered(T, shared=shared)
    for s, h, pp, d in [(0, 0, 0, 0), (1, 1, b - a - 1, 3)]:
        assert got(s, h, pp, d) == parent(s, h, a + pp, d)


def test_paged_chunk_composition_and_rejections():
    span = _paged_span("torch", _scattered(T))
    outer = T.submdspan(span, T.all_, T.all_, (2, 11), T.all_)
    assert (T.submdspan(outer, T.all_, T.all_, (3, 7), T.all_).layout
            == T.submdspan(span, T.all_, T.all_, (5, 9), T.all_).layout)
    assert T.submdspan(span, (1, 2), T.all_, (0, 12), T.all_).layout.block_table == ((7, 1, 3),)
    for spec in [(0, T.all_, (0, 4), T.all_), (T.all_, (0, 1), (0, 4), T.all_),
                 (T.all_, T.all_, (0, 4), (0, 2))]:
        with pytest.raises(T.LayoutError):
            T.submdspan(span, *spec)


# =====================================================================================
# algorithms
# =====================================================================================
SYM = np.array([[1.0, 2.0, 3.0], [2.0, 5.0, 6.0], [3.0, 6.0, 9.0]], np.float32)


def _sym_span(p, x=SYM):
    c = PKGS[p]
    return c.MdSpan.from_dense(arr(p, x), layout=c.LayoutSymmetricPacked(
        c.Extents.fully_dynamic(*x.shape)))


ALGO_CASES = {
    "scale_dense": lambda p, c, alg: alg.scale(
        c.MdSpan.from_dense(arr(p, np.arange(6, dtype=np.float32).reshape(2, 3))), 2.0).to_dense(),
    "scale_symmetric": lambda p, c, alg: alg.scale(_sym_span(p), 2.0).to_dense(),
    "scale_tiled_unique": lambda p, c, alg: alg.scale(c.MdSpan.from_dense(
        arr(p, np.arange(30, dtype=np.float32).reshape(5, 6)),
        layout=c.LayoutTiledTPU(c.Extents.fully_dynamic(5, 6), tile=(2, 4))), 3.0).to_dense(),
    "scale_quantized_buffers": lambda p, c, alg: alg.scale(c.MdSpan.from_dense(
        arr(p, np.linspace(-1, 1, 16, dtype=np.float32).reshape(2, 8)),
        accessor=c.QuantizedAccessor(DT[p], bits=8, block=8)), 3.0).buffers["scale"],
    "scale_quantized_q": lambda p, c, alg: alg.scale(c.MdSpan.from_dense(
        arr(p, np.linspace(-1, 1, 16, dtype=np.float32).reshape(2, 8)),
        accessor=c.QuantizedAccessor(DT[p], bits=4, block=8)), 3.0).buffers["q"],
    "dot_symmetric": lambda p, c, alg: alg.dot(_sym_span(p), _sym_span(p)),
    "reduce_sum_symmetric": lambda p, c, alg: alg.reduce_sum(_sym_span(p)),
    "matvec_right": lambda p, c, alg: alg.matvec(
        c.MdSpan.from_dense(arr(p, np.arange(12, dtype=np.float32).reshape(3, 4))),
        c.MdSpan.from_dense(arr(p, np.arange(4, dtype=np.float32)))),
    "matvec_left": lambda p, c, alg: alg.matvec(c.MdSpan.from_dense(
        arr(p, np.arange(12, dtype=np.float32).reshape(3, 4)),
        layout=c.LayoutLeft(c.Extents.fully_dynamic(3, 4))),
        c.MdSpan.from_dense(arr(p, np.arange(4, dtype=np.float32)))),
    "fill_dense": lambda p, c, alg: alg.fill(
        c.MdSpan.from_dense(arr(p, np.zeros((2, 3), np.float32))), 7.0).to_dense(),
    "fill_paged": lambda p, c, alg: alg.fill(_paged_span(p, _scattered(c)), 7.0).buffers,
    "copy_dense": lambda p, c, alg: alg.copy(
        c.MdSpan.from_dense(arr(p, np.zeros((2, 3), np.float32))),
        c.MdSpan.from_dense(arr(p, np.arange(6, dtype=np.float32).reshape(2, 3)))).to_dense(),
    "add_into_unique": lambda p, c, alg: alg.add_into(
        c.MdSpan.from_dense(arr(p, np.ones((2, 3), np.float32))),
        c.MdSpan.from_dense(arr(p, np.arange(6, dtype=np.float32).reshape(2, 3)))).to_dense(),
    "add_into_accumulate": lambda p, c, alg: alg.add_into(
        c.MdSpan(_sym_span(p, SYM[:2, :2]).buffers, _sym_span(p, SYM[:2, :2]).layout,
                 c.AccumulateAccessor(DT[p])), _sym_span(p, SYM[:2, :2])).to_dense(),
}


@pytest.mark.parametrize("case", sorted(ALGO_CASES))
def test_algorithms_match_reference(case):
    got = npy(ALGO_CASES[case]("torch", T, talg))
    want = npy(ALGO_CASES[case]("jax", J, jalg))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_scale_quantized_touches_only_scales():
    m = T.MdSpan.from_dense(torch.linspace(-1, 1, 16).reshape(2, 8),
                            accessor=T.QuantizedAccessor(torch.float32, bits=8, block=8))
    r = talg.scale(m, 3.0)
    assert torch.equal(r.buffers["q"], m.buffers["q"])
    torch.testing.assert_close(r.buffers["scale"], 3 * m.buffers["scale"])


def test_algorithm_gates_match_reference():
    """The LayoutError gates: scale over a non-unique, non-contiguous layout,
    add_into a non-unique layout without accumulation, copy into one."""
    for p, c in PKGS.items():
        alg = talg if p == "torch" else jalg
        lay = c.LayoutStride(c.Extents.fully_dynamic(2, 2), strides=(1, 1), offset=1)
        m = c.MdSpan(arr(p, np.zeros(4, np.float32)), lay, c.BasicAccessor(DT[p]))
        with pytest.raises(c.LayoutError):
            alg.scale(m, 2.0)
        with pytest.raises(c.LayoutError):
            alg.add_into(_sym_span(p), _sym_span(p))
        with pytest.raises(c.LayoutError):
            alg.copy(_sym_span(p), _sym_span(p))
        with pytest.raises(c.LayoutError):
            alg.dot(_sym_span(p), c.MdSpan.from_dense(arr(p, np.zeros((2, 2), np.float32))))
