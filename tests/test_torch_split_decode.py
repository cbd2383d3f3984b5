"""The split-K decode's plain pieces, on the CPU: the per-split partials,
their log-sum-exp combine and the split planner, over a paged pool and over
a dense cache.

The CUDA decode body cuts each row's keys into runs, leaves a partial
(m, l, acc) per run and merges them in a second kernel; its plain
counterparts here must give the unsplit plain decode back. Paged: cut into
1, 2, 7 and max_pages splits, with all-dead splits (a short row) and
length-0 rows, the combine equals paged_decode_attention_torch within 2e-5
(f32: the same terms summed in another grouping). Dense (flash_decode's
split): at recurrentgemma's head shape (D 256, G 10, Hkv 1) over a small
cache and ring, before, on and past a split edge, at pos 0 and with a
window, the combine equals decode_attention_torch and the reference's Pallas
flash_decode (interpret mode), within 2e-5.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels.flash_attention import flash_decode as jax_flash_decode
from repro_torch.kernels import flash_attention as fa
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


# ---------------------------------------------------------------------------------
# the dense cache (flash_decode's split): the planner at page_size 1
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("s_len,batch,hkv,head_dim", [
    (288, 8, 2, 64),  # qwen2-0.5b's generate cache
    (2048, 2, 1, 256),  # recurrentgemma-2b's ring
    (1, 2, 1, 256), (37, 2, 1, 256), (33, 4, 2, 64), (1000, 1, 1, 128), (2600, 2, 1, 256),
    (4099, 8, 2, 16),
])
def test_dense_split_plan_invariants(s_len, batch, hkv, head_dim):
    """S one-slot pages: the splits cover the cache, none lies wholly past it
    (no split is empty by shape), each is whole tiles of 64 keys (32 above D
    64) or the whole cache."""
    splits, kps = pa.plan_decode_splits(s_len, batch, hkv, 1, head_dim, 132)
    tile = 64 if head_dim <= 64 else 32
    assert splits >= 1 and kps >= 1
    assert splits * kps >= s_len and (splits - 1) * kps < s_len
    assert kps % tile == 0
    assert splits * batch * hkv < 2 * 132 + batch * hkv  # about two blocks a SM, no more


def test_dense_split_plans_at_the_generate_shapes():
    # on 132 SMs: the ring runs 64 splits of 32 keys (x 2 row blocks x B 2:
    # 256 blocks), qwen2's cache 5 splits of 64 (80 blocks)
    assert pa.plan_decode_splits(2048, 2, 1, 1, 256, 132) == (64, 32)
    assert pa.plan_decode_splits(288, 8, 2, 1, 64, 132) == (5, 64)


S_RING, D256, G10 = 96, 256, 10


def _dense_inputs(seed, b=2, s_len=S_RING):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)
    return f(b, G10, 1, D256), f(b, 1, s_len, D256), f(b, 1, s_len, D256)


@pytest.mark.parametrize("kps", [16, 32, 96])
@pytest.mark.parametrize("window", [None, 24])
def test_dense_split_partials_combine_to_the_decode_and_the_pallas_kernel(kps, window):
    """Positions 0, one before, on and one past the first split edge, and
    S - 1; the partials of splits wholly past pos (or before pos - window)
    are dead (l 0, m -inf)."""
    q, k, v = _dense_inputs(kps)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    jitted = jax.jit(lambda q, k, v, p: jax_flash_decode(q, k, v, p, window=window, block_k=32))
    for pos in sorted({0, kps - 1, kps, min(kps + 1, S_RING - 1), S_RING - 1}):
        m, l, acc = fa.decode_partials_torch(tq, tk, tv, pos, keys_per_split=kps, window=window)
        splits = -(-S_RING // kps)
        assert m.shape == (2, G10, splits) and acc.shape == (2, G10, splits, D256)
        lo = 0 if window is None else max(0, pos - window + 1)
        dead = [sp for sp in range(splits) if sp * kps > pos or (sp + 1) * kps <= lo]
        assert all((l[..., sp] == 0).all() and torch.isneginf(m[..., sp]).all() for sp in dead)
        got = pa.combine_splits_torch(m, l, acc)[:, :, None]
        torch.testing.assert_close(got, fa.decode_attention_torch(tq, tk, tv, pos, window=window),
                                   **TOL)
        want = jitted(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(pos))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("pos", [0, 40, S_RING - 1, S_RING, S_RING + 31, 3 * S_RING + 5])
def test_dense_split_partials_on_a_ring(pos):
    """A ring of S slots read as the port's windowed decode does (slots <=
    min(pos, S - 1), no window): split partials + combine equal the Pallas
    flash_decode at the same clamped position, before and after the wrap."""
    q, k, v = _dense_inputs(pos + 1)
    last = min(pos, S_RING - 1)
    _, kps = pa.plan_decode_splits(S_RING, 2, 1, 1, D256, 132)
    m, l, acc = fa.decode_partials_torch(*(torch.from_numpy(x) for x in (q, k, v)), last,
                                         keys_per_split=kps)
    want = jax_flash_decode(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.int32(last),
                            block_k=32)
    np.testing.assert_allclose(pa.combine_splits_torch(m, l, acc)[:, :, None].numpy(),
                               np.asarray(want), **TOL)
