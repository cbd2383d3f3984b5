"""The split-K paged decode's plain pieces, on the CPU: the per-split
partials, their log-sum-exp combine and the split planner.

The CUDA decode kernel cuts each row's pages into runs, leaves a partial
(m, l, acc) per run and merges them in a second kernel; its plain
counterparts here must give the unsplit plain decode back. Cut into 1, 2, 7
and max_pages splits, with all-dead splits (a short row) and length-0 rows,
the combine equals paged_decode_attention_torch within 2e-5 (f32: the same
terms summed in another grouping).
"""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa

B, HQ, HKV, D, PS, MAX_PAGES = 5, 8, 2, 16, 4, 14
TOL = dict(rtol=2e-5, atol=2e-5)


def _inputs(lens, seed=0):
    rng = np.random.default_rng(seed)
    num = B * MAX_PAGES + 1
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))
    bt = torch.from_numpy(rng.permutation(np.arange(1, num)).reshape(B, MAX_PAGES)
                          .astype(np.int32))
    return (f(B, HQ, 1, D), f(num, HKV, PS, D), f(num, HKV, PS, D), bt,
            torch.tensor(lens, dtype=torch.int32))


# a length-0 row, one inside the first page (every later split dead), one on a
# 2-page split boundary, one past it, and the full table
LENS = [0, 3, 8, 9, MAX_PAGES * PS]


@pytest.mark.parametrize("splits", [1, 2, 7, MAX_PAGES])
def test_combined_splits_equal_the_unsplit_decode(splits):
    pps = MAX_PAGES // splits
    assert -(-MAX_PAGES // pps) == splits
    args = _inputs(LENS)
    m, l, acc = pa.paged_decode_partials_torch(*args, pages_per_split=pps)
    assert m.shape == (B, HQ, splits) and acc.shape == (B, HQ, splits, D)
    got = pa.combine_splits_torch(m, l, acc).reshape(B, HQ, 1, D)
    torch.testing.assert_close(got, pa.paged_decode_attention_torch(*args), **TOL)
    assert torch.count_nonzero(got[0]) == 0  # the length-0 row: exact zeros
    if splits > 1:  # the short row's later splits are dead: l 0, m -inf
        assert (l[1, :, 1:] == 0).all() and torch.isneginf(m[1, :, 1:]).all()


def test_combine_never_reads_a_dead_splits_accumulator():
    """A dead split's m and acc may hold anything (the kernel leaves them
    unwritten): NaN there must not reach the output."""
    args = _inputs(LENS, seed=1)
    m, l, acc = pa.paged_decode_partials_torch(*args, pages_per_split=2)
    dead = l == 0
    acc = torch.where(dead[..., None], torch.full_like(acc, float("nan")), acc)
    m = torch.where(dead, torch.full_like(m, float("nan")), m)
    got = pa.combine_splits_torch(m, l, acc).reshape(B, HQ, 1, D)
    torch.testing.assert_close(got, pa.paged_decode_attention_torch(*args), **TOL)


@pytest.mark.parametrize("max_pages", [1, 3, 4, 5, 16, 127, 128, 1000])
@pytest.mark.parametrize("batch,hkv", [(1, 1), (8, 2), (64, 8)])
@pytest.mark.parametrize("page_size,head_dim", [(16, 64), (16, 128), (4, 16), (64, 64),
                                                (128, 64)])
def test_split_plan_invariants(max_pages, batch, hkv, page_size, head_dim):
    splits, pps = pa.plan_decode_splits(max_pages, batch, hkv, page_size, head_dim, 132)
    tile = max(1, (64 if head_dim <= 64 else 32) // page_size)
    assert splits >= 1
    assert pps % tile == 0 or pps >= max_pages  # every split takes whole tiles
    assert splits * pps >= max_pages  # the splits cover the table
    assert (splits - 1) * pps < max_pages  # and none lies wholly past it
    if splits > 1:  # split only where the blocks fall short of two a SM
        assert splits * batch * hkv < 2 * 132 + batch * hkv * (pps // tile)


def test_split_plan_at_the_serve_shape():
    # qwen2-0.5b's serve decode (B 8 x Hkv 2, 128 pages of 16, D 64) on 132 SMs:
    # 16 splits of 8 pages (two 64-token tiles), 256 blocks
    assert pa.plan_decode_splits(128, 8, 2, 16, 64, 132) == (16, 8)
