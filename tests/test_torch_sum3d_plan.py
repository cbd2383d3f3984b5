"""Sum3D's grid on the CPU, and a plain twin of the kernel's partition held
against the reference.

The kernel (csrc/paper_suite.cu, the Sum3D section) cuts a buffer of n
elements into a head (the elements before its first 16-byte boundary),
whole 16-byte vectors walked grid-stride by the blocks, and a tail (the
elements after the last whole vector); block 0 adds the head and the tail.
``_cover`` below writes that cut down; plan_sum3d gives the grid. The
invariants: head, vectors and tail cover every element once, the head stops
at the 16-byte boundary, head and tail are each fewer than a vector's
elements, the blocks' shares of vectors differ by at most one vector a
thread, the grid is at least 1 and at most one wave of the card's resident
blocks (one wave where the buffer gives each block a whole step, every block
but the last a whole step otherwise), and the grid depends on its arguments
only. The SM count and the occupancy the wrapper asks the library for are
stubbed (an H100's 132 SMs, a few resident blocks).

The twin sums each block's share in f32 and folds the partials in index
order, as the kernel does (in another order within a block); it is held
against the Pallas ``sum3d_pallas`` in interpret mode and ``ref.sum3d`` on
the same numpy inputs, at the tolerances of tests/test_torch_paper_kernels.py
(2e-5 f32, 2e-2 bf16). The CUDA kernel is held against the plain version,
and against exact integer sums bit for bit, in test_torch_kernels_cuda.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref as jref
from repro.kernels.sum3d import sum3d_pallas
from repro_torch.kernels import sum3d as tsum

SMS = 132  # an H100 SXM
RESIDENT = 8  # blocks of 256 threads an SM
T, VB, VECS = tsum.THREADS, tsum.VEC_BYTES, tsum.VECS
STEP = T * VECS  # vectors a block takes in one step of its walk
WAVE = RESIDENT * SMS
# (element bytes, bytes off 16): every alignment a tensor of the dtype can have
ALIGNMENTS = [(4, off) for off in range(0, 16, 4)] + [(2, off) for off in range(0, 16, 2)]
SIZES = [0, 1, 7, 8, 9, 31, 33, 1000, 4096 + 5, STEP * 16 + 3, WAVE * STEP - 1,
         WAVE * STEP * 8 + 17, 96 ** 3, 95 * 97 * 99]


def _cover(n, esize, off):
    """(head, vectors, tail) of n elements of ``esize`` bytes from ``off``
    bytes past a 16-byte boundary, as the kernel's launch cuts them: the head
    runs to the first boundary (all n where n is fewer)."""
    lanes = VB // esize
    head = min(-off % VB // esize, n)
    vectors = (n - head) // lanes
    return head, vectors, n - head - vectors * lanes


def _shares(vectors, grid):
    """Vectors of each block: vector v is block (v // T) % grid's."""
    rows, last = divmod(vectors, T)
    per_row = np.full(rows + (last > 0), T, dtype=np.int64)
    if last:
        per_row[-1] = last
    return np.bincount(np.arange(len(per_row)) % grid, weights=per_row,
                       minlength=grid).astype(np.int64)


@pytest.mark.parametrize("n", SIZES)
@pytest.mark.parametrize("esize,off", ALIGNMENTS, ids=[f"e{e}+{o}" for e, o in ALIGNMENTS])
def test_plan_covers_every_element_once(n, esize, off):
    grid = tsum.plan_sum3d(n, esize, SMS, RESIDENT)
    head, vectors, tail = _cover(n, esize, off)
    lanes = VB // esize
    assert grid == tsum.plan_sum3d(n, esize, SMS, RESIDENT)  # its arguments only
    assert head + vectors * lanes + tail == n
    assert min(head, vectors, tail) >= 0
    assert head * esize < VB and tail < lanes
    if head < n:  # the vectors start on a 16-byte boundary
        assert (off + head * esize) % VB == 0
    else:
        assert vectors == tail == 0
    shares = _shares(vectors, grid)
    assert shares.sum() == vectors
    assert shares.max() - shares.min() <= T  # at most one vector a thread apart
    assert 1 <= grid <= WAVE
    if vectors >= WAVE * STEP:
        assert grid == WAVE  # one wave of the card
    else:  # every block but the last a whole step, the grid no more than that
        assert (grid - 1) * STEP <= vectors
        assert grid == max(1, -(-(n * esize // VB) // STEP))


@pytest.mark.parametrize("resident", [1, 3, 8, 16])
def test_plan_grid_is_one_wave_of_the_resident_blocks(resident):
    """512^3 fills one wave at any occupancy; 96^3 (the reference's size) is
    cut to a whole step a block where that is fewer blocks."""
    for esize in (4, 2):
        lanes = VB // esize
        assert tsum.plan_sum3d(512 ** 3, esize, SMS, resident) == resident * SMS
        assert _cover(512 ** 3, esize, 0) == (0, 512 ** 3 // lanes, 0)
        small = tsum.plan_sum3d(96 ** 3, esize, SMS, resident)
        assert small == min(resident * SMS, 96 ** 3 // lanes // STEP)
    assert tsum.plan_sum3d(10 ** 6, 4, SMS, 0) >= 1  # an occupancy of 0 still launches


def _partials(xf, esize, off, grid):
    """The kernel's block partials, in f32: block b's vectors summed, block 0
    also the head and the tail."""
    lanes = VB // esize
    head, vectors, tail = _cover(xf.numel(), esize, off)
    body = xf[head:head + vectors * lanes]
    rows = -(-vectors // T)
    padded = torch.zeros(rows * T * lanes, dtype=torch.float32)
    padded[:body.numel()] = body
    row_sums = padded.view(rows, T * lanes).sum(dim=1)
    partials = torch.zeros(grid, dtype=torch.float32)
    for b in range(grid):
        partials[b] = row_sums[b::grid].sum()
    ends = torch.cat([xf[:head], xf[xf.numel() - tail:]])
    partials[0] += ends.sum()
    return partials


def sum3d_by_plan(x, esize, off):
    """The plain twin of the kernel's partition of x (its elements taken as
    ``esize`` bytes each, ``off`` bytes past a 16-byte boundary) on the
    planner's grid: per-block partials, then the fold in index order."""
    grid = tsum.plan_sum3d(x.numel(), esize, SMS, RESIDENT)
    total = torch.zeros((), dtype=torch.float32)
    for p in _partials(x.reshape(-1).float(), esize, off, grid):
        total = total + p
    return total


TWIN_SHAPES = [(1, 1, 1), (1, 1, 7), (1, 1, 9), (1, 1, 33), (5, 7, 130), (16, 24, 136),
               (95, 97, 99)]
DTYPES = {"f32": (jnp.float32, torch.float32, 2e-5), "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
TWIN_OFFSETS = {"f32": (0, 4, 12), "bf16": (0, 2, 14)}


@pytest.mark.parametrize("shape", TWIN_SHAPES, ids=["x".join(map(str, s)) for s in TWIN_SHAPES])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_twin_of_the_partition_matches_pallas_and_ref(shape, dtype):
    x = np.random.default_rng(sum(shape)).standard_normal(shape).astype(np.float32)
    jd, td, tol = DTYPES[dtype]
    jx, tx = jnp.asarray(x, jd), torch.from_numpy(x).to(td)
    want_pallas, want_ref = float(sum3d_pallas(jx)), float(jref.sum3d(jx))
    for off in TWIN_OFFSETS[dtype]:
        got = sum3d_by_plan(tx, tx.element_size(), off)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), want_pallas, rtol=tol, atol=tol)
        np.testing.assert_allclose(float(got), want_ref, rtol=tol, atol=tol)


def test_twin_adds_each_element_once():
    """On integer values the sum is exact in any order, so the twin gives the
    exact total at every alignment: no element is dropped or added twice."""
    n = WAVE * STEP // 2 + 37
    x = torch.from_numpy(np.random.default_rng(5).integers(-3, 4, n).astype(np.float32))
    exact = float(x.double().sum())
    for esize, off in ALIGNMENTS:
        assert float(sum3d_by_plan(x, esize, off)) == exact
