"""The RG-LRU scan's geometry and Stencil3D's plan, on the CPU.

rglru_scan launches one block a work item (a sequence's GEOMETRY["columns"]
columns): at recurrentgemma-2b's width that is more blocks than an H100 has
SMs, each stage row is whole 16-byte copies, and the ring fits a block's
shared memory. plan_stencil3d: the blocks' tiles and runs cover every output
exactly once, each run stages the planes its interior outputs need (two halo
planes at most), the runs are the shortest whose blocks fit one wave of the
card (MAX_RUN where even those are more), and its reach (the
grid's y and z) is refused past its end. The SM count and the occupancy the
stencil's wrapper asks the library for are stubbed here (an H100's 132 SMs,
a few resident blocks). The CUDA kernels are held against the plain versions
bit for bit in test_torch_kernels_cuda.py.
"""
import itertools

import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import rglru_scan as rs
from repro_torch.kernels import stencil3d as st
from repro_torch.kernels._paper_suite import GEOMETRY as PAPER_GEOMETRY

SMS = 132  # an H100 SXM
ESIZES = {"f32": 4, "bf16": 2}
C = rs.GEOMETRY["columns"]


# ---------------------------------------------------------------------------------
# rglru_scan
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("dt", sorted(ESIZES))
def test_rglru_geometry_at_recurrentgemma_width(dt):
    """B 2 x W 2560: 160 blocks of 32 columns, more than the 132 SMs; a row of
    a stage is 128 bytes in f32 and 64 in bf16, whole 16-byte copies; the
    ring fits a block's shared memory; one chain lane a column in whole
    warps, the load warps besides."""
    esz = ESIZES[dt]
    assert 2 * -(-2560 // C) == 160 > SMS
    assert C * esz >= 64 and C * esz % 16 == 0
    g = rs.GEOMETRY
    assert g["stages"] * 2 * g["steps"] * C * esz <= PAPER_GEOMETRY["smem_opt_in"]
    chain = 32 * -(-C // 32)
    assert g["threads"] > chain and (g["threads"] - chain) % 32 == 0


# ---------------------------------------------------------------------------------
# stencil3d
# ---------------------------------------------------------------------------------
TJ, TK = st.TILE_J, st.TILE_K
STENCIL_SHAPES = [(1, 1, 1), (1, 4, 4), (2, 5, 5), (3, 3, 3), (7, 2, 9), (5, 33, 65),
                  (12, 10, 132), (65, 17, 33), (96, 96, 96), (130, 20, 131), (512, 512, 512)]


def _run_planes(plan, r, i):
    """Run r's output planes and the input planes the kernel stages for it
    (csrc/paper_suite.cu's stencil3d_kernel: its interior outputs' planes
    ib .. ie - 1, each with the plane before and after; the boundary planes
    0 and I - 1 are written as 0 and need none), as ranges."""
    i0, i1 = r * plan.run, min((r + 1) * plan.run, i)
    ib, ie = max(i0, 1), min(i1, i - 1)
    return range(i0, i1), (range(ib - 1, ie + 1) if ib < ie else range(0))


def _coverage(plan, shape):
    """How many blocks own each output (I, J, K), from the plan's tiles and
    runs."""
    i, j, k = shape
    count = torch.zeros(shape, dtype=torch.int32)
    for r in range(plan.runs):
        outs, _ = _run_planes(plan, r, i)
        for jt, kt in itertools.product(range(plan.tiles_j), range(plan.tiles_k)):
            count[outs.start:outs.stop, jt * TJ:(jt + 1) * TJ, kt * TK:(kt + 1) * TK] += 1
    return count


@pytest.mark.parametrize("shape", STENCIL_SHAPES, ids=["x".join(map(str, s))
                                                       for s in STENCIL_SHAPES])
def test_stencil_plan_covers_every_output_once_and_stages_its_halo(shape):
    i, j, k = shape
    for resident in (1, 2, 4, 8):
        plan = st.plan_stencil3d(i, j, k, SMS, resident)
        assert 1 <= plan.run <= st.MAX_RUN
        assert plan.tiles_j == -(-j // TJ) and plan.tiles_k == -(-k // TK)
        assert 1 <= plan.runs <= st.MAX_GRID_YZ and plan.tiles_j <= st.MAX_GRID_YZ
        assert (plan.runs - 1) * plan.run < i <= plan.runs * plan.run  # no empty run
        if i <= 64:  # the whole array, block by block (the large shapes by planes below)
            assert bool((_coverage(plan, shape) == 1).all())
        owned, staged = [], 0
        for r in range(plan.runs):
            outs, ins = _run_planes(plan, r, i)
            owned += list(outs)
            staged += len(ins)
            interior = [p for p in outs if 0 < p < i - 1]
            assert len(ins) == (len(interior) + 2 if interior else 0) <= plan.run + 2
            for p in interior:  # each interior output's planes are staged by its run
                assert {p - 1, p, p + 1} <= set(ins)
            assert all(0 <= p < i for p in ins)
        assert owned == list(range(i))
        tiles, slots = plan.tiles_j * plan.tiles_k, resident * SMS
        if plan.run < st.MAX_RUN:  # one wave: the blocks fit the slots at once ...
            assert plan.blocks <= max(slots, tiles)
        if plan.run > 1:  # ... and one plane shorter they would not
            assert -(-i // (plan.run - 1)) * tiles > max(slots, tiles)


def test_stencil_plan_at_the_paper_sizes():
    """512^3: runs of MAX_RUN (32) planes over 8 x 64 tiles, 8192 blocks, the
    halo planes ~6% more staged planes than outputs; 96^3 (the reference's):
    runs shortened to 5 planes, 480 blocks, one wave of 4 resident a SM."""
    big = st.plan_stencil3d(512, 512, 512, SMS, 4)
    assert (big.run, big.tiles_j, big.tiles_k, big.runs, big.blocks) == (32, 64, 8, 16, 8192)
    staged = sum(len(_run_planes(big, r, 512)[1]) for r in range(big.runs))
    assert staged == 512 + 2 * big.runs - 2 and staged / 512 < 1.06
    small = st.plan_stencil3d(96, 96, 96, SMS, 4)
    assert (small.run, small.blocks) == (5, 480) and SMS < small.blocks <= 4 * SMS
    assert st.plan_stencil3d(7, 2, 9, SMS, 4).run == 1  # runs of one plane
    # the tile's threads: TILE_J / rows warps' worth of TILE_K lanes
    g = PAPER_GEOMETRY
    assert g["stencil_threads"] == g["stencil_tile_j"] // g["stencil_rows"] * g["stencil_tile_k"]
    assert g["stencil_tile_j"] % g["stencil_rows"] == 0 and g["stencil_planes"] >= 2


def test_stencil_grid_reach_is_refused_past_its_end():
    """The grid's y holds J / TILE_J tiles and its z I / MAX_RUN runs, each at
    most 65535: the planner and the wrapper's check refuse past that."""
    assert st.MAX_J == TJ * 65535 and st.MAX_I == st.MAX_RUN * 65535
    edge = st.plan_stencil3d(st.MAX_I, 1, 1, SMS, 4)
    assert edge.runs == st.MAX_GRID_YZ and edge.run == st.MAX_RUN
    assert st.plan_stencil3d(1, st.MAX_J, 1, SMS, 4).tiles_j == st.MAX_GRID_YZ
    for shape in ((st.MAX_I + 1, 1, 1), (1, st.MAX_J + 1, 1)):
        with pytest.raises(ValueError, match="grid covers"):
            st.plan_stencil3d(*shape, SMS, 4)
        with pytest.raises(ValueError, match="grid covers"):
            st.check_reach(shape)
    st.check_reach((st.MAX_I, st.MAX_J, 1))


def test_stencil_plan_depends_on_the_shape_and_occupancy_only():
    a = st.plan_stencil3d(96, 96, 96, SMS, 4)
    assert a == st.plan_stencil3d(96, 96, 96, SMS, 4)
    assert st.plan_stencil3d(96, 96, 96, SMS, 8).run < a.run  # more slots: shorter runs
    assert st.plan_stencil3d(96, 96, 96, SMS, 0) == st.plan_stencil3d(96, 96, 96, SMS, 1)
