"""The paper-suite kernels' plain PyTorch versions against the reference's
Pallas kernels (interpret mode on the CPU), with the reference's sweeps and
tolerances (tests/test_kernels_paper.py): sum3d 2e-5 (f32) / 2e-2 (bf16),
stencil3d 1e-4, tinymatsum 1e-6 / 2e-2, matvec 2e-4. The same numpy inputs
go to both packages. stencil3d compares in f32: the reference's oracle
returns f32 for a bf16 input while its kernel (and the port) keep x's dtype.
The ``ops`` dispatchers on MdSpans of both layouts are held against
``repro.kernels.ops`` with ``impl="pallas"``. The CUDA kernels are held
against these plain versions in test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.core as J
import repro_torch.core as T
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.matvec import matvec_left as jax_matvec_left
from repro.kernels.matvec import matvec_right as jax_matvec_right
from repro.kernels.stencil3d import stencil3d_pallas
from repro.kernels.sum3d import sum3d_mdspan as jax_sum3d_mdspan
from repro.kernels.sum3d import sum3d_pallas
from repro.kernels.tinymatsum import tinymatsum_dynamic as jax_tiny_dynamic
from repro.kernels.tinymatsum import tinymatsum_static as jax_tiny_static
from repro_torch import kernels
from repro_torch.kernels import matvec as tmv
from repro_torch.kernels import ops
from repro_torch.kernels import stencil3d as tst
from repro_torch.kernels import sum3d as tsum
from repro_torch.kernels import tinymatsum as ttiny
from repro_torch.kernels.common import cdiv, pad_to, pick_block, round_up

SHAPES_3D = [(4, 4, 8), (8, 16, 128), (16, 24, 136), (5, 7, 130)]
DTYPES = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16, torch.bfloat16)}


def inputs(seed, shape, dtype="f32"):
    """The same values for both packages: (jax array, torch tensor); bf16 is
    rounded once from the f32 draw by each package (both round to nearest
    even)."""
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    jd, td = DTYPES[dtype]
    return jnp.asarray(x, jd), torch.from_numpy(x).to(td)


def f32(a) -> np.ndarray:
    return a.float().numpy() if isinstance(a, torch.Tensor) else np.asarray(a, np.float32)


@pytest.mark.parametrize("shape", SHAPES_3D)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_sum3d_plain_matches_pallas(shape, dtype):
    jx, tx = inputs(0, shape, dtype)
    tol = 2e-2 if dtype == "bf16" else 2e-5
    got = tsum.sum3d(tx)  # a CPU tensor: the wrapper returns the plain version
    assert got.dtype == torch.float32 and got.shape == ()
    np.testing.assert_allclose(float(got), float(sum3d_pallas(jx)), rtol=tol, atol=tol)
    assert float(tsum.sum3d_torch(tx)) == float(got)


@pytest.mark.parametrize("order", ["right", "left"])
def test_sum3d_layout_dispatch_matches_pallas(order):
    jx, tx = inputs(1, (6, 10, 132))
    spans = {}
    for name, c, x in (("jax", J, jx), ("torch", T, tx)):
        layout = c.LayoutRight if order == "right" else c.LayoutLeft
        lay = layout(c.Extents.fully_dynamic(6, 10, 132))
        spans[name] = c.MdSpan.from_dense(x, layout=lay)
    np.testing.assert_allclose(float(tsum.sum3d_mdspan(spans["torch"])),
                               float(jax_sum3d_mdspan(spans["jax"])), rtol=2e-4)


@pytest.mark.parametrize("shape", [(6, 8, 16), (12, 10, 132), (4, 4, 4)])
@pytest.mark.parametrize("br", [1, 2, 4])
def test_stencil3d_plain_matches_pallas(shape, br):
    jx, tx = inputs(2, shape)
    got = tst.stencil3d(tx)
    assert got.dtype == torch.float32 and got.shape == shape
    np.testing.assert_allclose(f32(got), f32(stencil3d_pallas(jx, block_rows=br)),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", [(2, 5, 5), (6, 2, 9), (5, 6, 7)])
def test_stencil3d_bf16_keeps_dtype_and_small_extents_give_zeros(shape):
    """Output in x's dtype (as the Pallas kernel; the reference oracle returns
    f32, compared here in f32); any extent < 3 leaves no interior."""
    jx, tx = inputs(3, shape, "bf16")
    got = tst.stencil3d_torch(tx)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(f32(got), f32(jref.stencil3d(jx)), rtol=1e-2, atol=1e-2)
    if min(shape) < 3:
        assert not got.any()


@pytest.mark.parametrize("n", [10, 100, 513])
@pytest.mark.parametrize("jk", [(3, 3), (5, 7), (8, 8)])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_tinymatsum_plain_matches_pallas(n, jk, dtype):
    jo, to = inputs(4, (n, *jk), dtype)
    js, ts = inputs(5, (n, *jk), dtype)
    tol = 2e-2 if dtype == "bf16" else 1e-6
    want_static = f32(jax_tiny_static(jo, js))
    want_dynamic = f32(jax_tiny_dynamic(jo, js, jmax=8, kmax=8))
    got_static = ttiny.tinymatsum_static(to, ts)
    got_dynamic = ttiny.tinymatsum_dynamic(to, ts, jmax=8, kmax=8)
    assert got_static.dtype == to.dtype and got_dynamic.dtype == to.dtype
    np.testing.assert_allclose(f32(got_static), want_static, rtol=tol, atol=tol)
    np.testing.assert_allclose(f32(got_dynamic), want_dynamic, rtol=tol, atol=tol)


def test_tinymatsum_dynamic_checks_its_envelope():
    o = torch.zeros(4, 5, 9)
    with pytest.raises(ValueError):
        ttiny.tinymatsum_dynamic(o, o, jmax=8, kmax=8)
    assert ttiny.tinymatsum_dynamic(o, o, jmax=8, kmax=9).shape == o.shape


@pytest.mark.parametrize("ij", [(8, 128), (200, 384), (256, 256)])
def test_matvec_plain_matches_pallas_both_layouts(ij):
    i, j = ij
    ja, ta = inputs(5, (i, j))
    jx, tx = inputs(6, (j,))
    want_right = f32(jax_matvec_right(ja, jx))
    want_left = f32(jax_matvec_left(ja.T, jx))
    np.testing.assert_allclose(f32(tmv.matvec_right(ta, tx)), want_right, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(f32(tmv.matvec_left(ta.t().contiguous(), tx)), want_left,
                               rtol=2e-4, atol=2e-4)


# ragged extents (no multiple of 4, 8 or 128): the CUDA kernels' scalar-load
# form and ragged runs. The Pallas matvec_left sums its padded rows when J
# passes its 512-column block and is no multiple of it (NaN in interpret
# mode), so J stays inside one block here.
RAGGED_IJ = [(3, 5), (37, 203), (131, 509), (300, 445), (1001, 77)]


@pytest.mark.parametrize("ij", RAGGED_IJ)
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_matvec_plain_matches_pallas_at_ragged_extents(ij, dtype):
    i, j = ij
    ja, ta = inputs(7, (i, j), dtype)
    jx, tx = inputs(8, (j,), dtype)
    tol = 2e-4 if dtype == "f32" else 2e-2
    np.testing.assert_allclose(f32(tmv.matvec_torch(ta, tx)), f32(jax_matvec_right(ja, jx)),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(f32(tmv.matvec_torch(ta, tx)), f32(jax_matvec_left(ja.T, jx)),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("rows", [1, 100, 128, 16384, 1 << 20])
@pytest.mark.parametrize("cols", [0, 1, 255, 4099, 16384])
@pytest.mark.parametrize("elem_size", [4, 2])
def test_matvec_left_plan_invariants(rows, cols, elem_size):
    """The left kernel's split of j: the runs cover J, none is empty by
    shape, each takes LEFT_MIN_COLS columns or all of J, and j is split only
    where the runs of rows fall short of two blocks a SM (132 SMs)."""
    splits, per = tmv.plan_matvec_left(rows, cols, elem_size, 132)
    assert splits >= 1 and per >= 1
    assert splits * per >= cols and (splits - 1) * per < max(cols, 1)
    runs = -(-rows // (32 * 16 // elem_size))
    if splits > 1:
        assert runs * (splits - 1) < 2 * 132 and per >= tmv.LEFT_MIN_COLS
    assert tmv.plan_matvec_left(16384, 16384, 4, 132) == (3, 5462)


# ---------------------------------------------------------------------------------
# the ops dispatchers
# ---------------------------------------------------------------------------------
def _spans(x_np, order):
    out = {}
    for name, c, x in (("jax", J, jnp.asarray(x_np)), ("torch", T, torch.from_numpy(x_np))):
        lay = (c.LayoutRight if order == "right" else c.LayoutLeft)(
            c.Extents.fully_dynamic(*x_np.shape))
        out[name] = c.MdSpan.from_dense(x, layout=lay)
    return out


@pytest.mark.parametrize("order", ["right", "left"])
@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_ops_dispatchers_match_reference(order, impl):
    rng = np.random.default_rng(7)
    x3 = rng.standard_normal((5, 7, 130)).astype(np.float32)
    s = _spans(x3, order)
    np.testing.assert_allclose(float(ops.sum3d(s["torch"], impl=impl)),
                               float(jops.sum3d(s["jax"], impl="pallas")), rtol=2e-5, atol=2e-5)
    a = rng.standard_normal((200, 384)).astype(np.float32)
    v = rng.standard_normal(384).astype(np.float32)
    s = _spans(a, order)
    np.testing.assert_allclose(
        f32(ops.matvec(s["torch"], torch.from_numpy(v), impl=impl)),
        f32(jops.matvec(s["jax"], jnp.asarray(v), impl="pallas")), rtol=2e-4, atol=2e-4)


def test_ops_plain_arguments_and_generic_layouts():
    """A plain CPU tensor goes to the plain version; a layout other than
    right/left is gathered through the layout first."""
    rng = np.random.default_rng(8)
    x3 = rng.standard_normal((4, 5, 6)).astype(np.float32)
    assert float(ops.sum3d(torch.from_numpy(x3))) == pytest.approx(float(jref.sum3d(x3)), rel=2e-5)
    a = rng.standard_normal((6, 5)).astype(np.float32)
    v = rng.standard_normal(5).astype(np.float32)
    np.testing.assert_allclose(f32(ops.matvec(torch.from_numpy(a), torch.from_numpy(v))),
                               a @ v, rtol=2e-5, atol=2e-5)
    tiled = T.MdSpan.from_dense(torch.from_numpy(a), layout=T.LayoutTiledTPU(
        T.Extents.fully_dynamic(6, 5), tile=(2, 4)))
    np.testing.assert_allclose(f32(ops.matvec(tiled, torch.from_numpy(v))), a @ v,
                               rtol=2e-5, atol=2e-5)
    o, s_ = inputs(9, (10, 3, 3))[1], inputs(10, (10, 3, 3))[1]
    for static in (True, False):
        torch.testing.assert_close(ops.tinymatsum(o, s_, static_extents=static), o + s_)
    jx, tx = inputs(11, (6, 8, 16))
    np.testing.assert_allclose(f32(ops.stencil3d(tx)), f32(jops.stencil3d(jx, impl="pallas")),
                               rtol=1e-4, atol=1e-4)


def test_impl_cuda_refuses_cpu_operands_and_cpu_runs_launch_nothing():
    kernels.reset_launch_counts()
    x = torch.zeros(2, 3, 4)
    m = T.MdSpan.from_dense(x)
    for call in (lambda: ops.sum3d(m, impl="cuda"),
                 lambda: ops.sum3d(x, impl="cuda"),
                 lambda: ops.matvec(T.MdSpan.from_dense(torch.zeros(3, 4)), torch.zeros(4),
                                    impl="cuda"),
                 lambda: ops.matvec(torch.zeros(3, 4), torch.zeros(4), impl="cuda"),
                 lambda: ops.tinymatsum(x, x, impl="cuda"),
                 lambda: ops.stencil3d(x, impl="cuda")):
        with pytest.raises(ValueError, match="impl='cuda'"):
            call()
    ops.sum3d(m)
    ops.stencil3d(x)
    assert not any(kernels.launch_counts().values())
    with pytest.raises(ValueError, match="impl must be"):
        ops.stencil3d(x, impl="pallas")


def test_shape_helpers_match_reference():
    from repro.kernels import common as jc

    for a, b in [(7, 2), (8, 4), (1, 8), (130, 128)]:
        assert cdiv(a, b) == jc.cdiv(a, b) and round_up(a, b) == jc.round_up(a, b)
    for args in [(100, 512), (1000, 512), (1000, 256, 128), (300, 64, 8), (5, 3, 8)]:
        assert pick_block(*args) == jc.pick_block(*args)
    x = np.arange(6, dtype=np.float32).reshape(2, 3)
    np.testing.assert_array_equal(pad_to(torch.from_numpy(x), (3, 5)).numpy(),
                                  np.asarray(jc.pad_to(jnp.asarray(x), (3, 5))))
    t = torch.from_numpy(x)
    assert pad_to(t, (2, 3)) is t
