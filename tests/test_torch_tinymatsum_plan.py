"""The TinyMatrixSum kernels' plan on the CPU: plan_tinymatsum's spans and
grid, and the stage stride both kernels share (tiny_stride).

The planner's invariants hold for every (J, K) the static kernel is
instantiated for (1..8 each), f32 and bf16, aligned or not, at N on either
side of a span and of a wave of blocks. The occupancy the wrappers ask the
library for is stubbed here (5 blocks an SM, what the card's query gives
the 3 x 3 kernels). The CUDA kernels are held against the plain version bit
for bit in test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import tinymatsum as ttiny
from repro_torch.kernels._paper_suite import GEOMETRY

SMS = 132  # an H100 SXM
RESIDENT = 5  # blocks an SM (the stubbed occupancy)
EXTENTS = [(j, k) for j in range(1, 9) for k in range(1, 9)]
ESIZES = {"f32": 4, "bf16": 2}
SMEM_DEFAULT = GEOMETRY["smem_default"]


def _plan(n, j, k, esz, aligned=True, resident=lambda smem: RESIDENT):
    return ttiny.plan_tinymatsum(n, j, k, esz, aligned, SMS, resident)


def _spans(plan, n):
    """(block, first matrix, matrices) of every span, block by block, each
    block's spans in the order the kernels walk them: b, b + grid, ..."""
    spans = -(-n // plan.bn)
    for b in range(plan.grid):
        for span in range(b, spans, plan.grid):
            first = span * plan.bn
            yield b, first, min(plan.bn, n - first)


def _ns(plan):
    """N on either side of one span and of one wave of blocks."""
    wave = plan.bn * plan.grid
    return sorted({1, max(1, plan.bn - 1), plan.bn, plan.bn + 1, wave - 1, wave, wave + 1,
                   3 * wave + 5})


@pytest.mark.parametrize("dt", sorted(ESIZES))
@pytest.mark.parametrize("jk", EXTENTS, ids=[f"{j}x{k}" for j, k in EXTENTS])
def test_plan_invariants_at_every_extent(jk, dt):
    """Spans start on 16 bytes (whole chunks a span), a block's stage fits
    48 KB (no opt-in for the static kernel's shapes), the grid is within
    the spans and the resident blocks, and the vector form only where the
    buffers and N J K bytes allow it."""
    j, k = jk
    esz = ESIZES[dt]
    big = _plan(8_000_000, j, k, esz)
    for n in _ns(big):
        for aligned in (True, False):
            plan = _plan(n, j, k, esz, aligned)
            assert plan.bn >= 1 and plan.bn * j * k * esz % 16 == 0
            assert plan.bn <= GEOMETRY["threads"]
            assert ttiny.stage_bytes(j, k, esz, plan.bn) <= SMEM_DEFAULT
            spans = -(-n // plan.bn)
            assert 1 <= plan.grid <= min(spans, RESIDENT * SMS) < 2 ** 31
            assert plan.vec == (aligned and n * j * k * esz % 16 == 0)


def test_plan_depends_on_shapes_and_alignment_only():
    a = _plan(8_000_000, 3, 3, 4)
    assert a == _plan(8_000_000, 3, 3, 4)
    assert _plan(8_000_000, 3, 3, 4, False) == ttiny.TinyPlan(a.bn, a.grid, False)
    # the HBM size: spans of 224 matrices (one a thread, 8064 bytes), as
    # many blocks as are resident
    assert (a.bn, a.grid, a.vec) == (224, RESIDENT * SMS, True)
    # the grid follows the occupancy it is given
    assert _plan(8_000_000, 3, 3, 4, resident=lambda smem: 1).grid == SMS
    # a small N is cut so that every SM gets a span
    small = _plan(10_000, 3, 3, 4)
    assert -(-10_000 // small.bn) >= SMS


@pytest.mark.parametrize("dt", sorted(ESIZES))
def test_spans_cover_every_matrix_once_and_in_order(dt):
    esz = ESIZES[dt]
    for j, k in [(3, 3), (8, 8), (5, 7), (1, 1), (2, 4)]:
        big = _plan(8_000_000, j, k, esz)
        for n in _ns(big):
            for plan in (big, _plan(n, j, k, esz)):
                seen = np.zeros(n, dtype=np.int64)
                last = {}
                for b, first, count in _spans(plan, n):
                    assert 0 < count <= plan.bn and first % plan.bn == 0
                    assert first * j * k * esz % 16 == 0  # on 16 bytes where the base is
                    assert first > last.get(b, -1)  # a block walks its spans in order
                    last[b] = first
                    seen[first:first + count] += 1
                assert (seen == 1).all()


@pytest.mark.parametrize("dt", sorted(ESIZES))
def test_stage_layout_keeps_chunks_whole_and_spreads_the_banks(dt):
    """Matrix m's element w at m * tiny_stride + w is one-to-one into a stage
    of bn * P elements; where a matrix is padded, each 16-byte chunk lands
    whole on a 16-byte slot; a warp's reads of element (j, k) of 32 matrices
    put at most 4 lanes on one bank (4-byte words; one word read by several
    lanes is one access), and 16-byte reads of padded matrices hit 8
    distinct bank groups a quarter warp."""
    esz = ESIZES[dt]
    v = 16 // esz
    for j, k in EXTENTS:
        jk, p = j * k, ttiny.tiny_stride(j * k, esz)
        assert p in (jk, jk + v)
        plan = _plan(8_000_000, j, k, esz)
        e = torch.arange(plan.bn * jk)
        idx = (e // jk) * p + e % jk
        assert len(set(idx.tolist())) == len(idx) and int(idx.max()) < plan.bn * p
        if p != jk:
            chunks = idx.view(-1, v)
            assert (chunks[:, 0] % v == 0).all()
            assert (chunks - chunks[:, :1] == torch.arange(v)).all()
            assert (p * esz // 16) % 2 == 1
        for w in range(jk):
            words = {(m * p + w) * esz // 4 for m in range(32)}
            banks = np.bincount([x % 32 for x in words], minlength=32)
            assert banks.max() <= 4, (j, k, w)
        if (p * esz) % 16 == 0:
            groups = {(m * p * esz // 16) % 8 for m in range(8)}
            assert len(groups) == 8


def test_tiny_stride_is_the_librarys():
    """The planner's copy of csrc/paper_suite.cu's tiny_stride at the shapes
    GEOMETRY holds (the library's own values, checked when it loads)."""
    assert ttiny.tiny_stride(64, 4) == GEOMETRY["tiny_stride_8x8_f32"]
    assert ttiny.tiny_stride(16, 2) == GEOMETRY["tiny_stride_4x4_bf16"]
    assert ttiny.tiny_stride(9, 4) == GEOMETRY["tiny_stride_3x3_f32"]


UNSTAGED = [(101, 101, 4), (200, 200, 4), (300, 300, 2), (1, 100_000, 4)]


@pytest.mark.parametrize("case", UNSTAGED, ids=[f"{j}x{k}x{e}" for j, k, e in UNSTAGED])
def test_planner_takes_the_unstaged_form_past_a_stage(case):
    """Matrices whose fewest whole chunks of both operands pass a block's
    shared memory plan the unstaged form (bn 0, scalar, a block a matrix,
    at most the resident blocks); those just inside it stay staged, with
    the opt-in."""
    j, k, esz = case
    unit = 16 // np.gcd(j * k * esz, 16)
    assert ttiny.stage_bytes(j, k, esz, unit) > GEOMETRY["smem_opt_in"]
    for n in (1, 7, 10_000):
        plan = _plan(n, j, k, esz)
        assert plan == ttiny.TinyPlan(0, min(n, RESIDENT * SMS), False)
    big = _plan(10, 100, 100, 4)  # 40 KB a matrix: staged with the opt-in
    assert big.bn >= 1
    assert SMEM_DEFAULT < ttiny.stage_bytes(100, 100, 4, big.bn) <= GEOMETRY["smem_opt_in"]
