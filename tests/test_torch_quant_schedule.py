"""The schedules of the redesigned kernels, in plain PyTorch, against the JAX
reference on seeded numpy inputs.

quant_matmul: ``quant_matmul_torch(..., plan=...)`` repeats the CUDA
kernel's arithmetic for the plan ``plan_quant_matmul`` picks (stream for
bf16 x at M <= 16, mma for bf16 x at M > 16, fma otherwise): the scale
factored out of each K-block's sum (stream, mma) or applied while
dequantizing (fma), K split
as the kernel splits it, the splits added in order. It is held against
``repro.kernels.ref.quant_matmul`` and the Pallas ``quant_matmul`` in
interpret mode at rtol/atol 2e-5 (f32; the reference's kernel-vs-oracle
bound): the schedules reorder f32 sums of up to 4864 terms of O(1 / sqrt(K))
and nothing more.

The bf16 chunk body: ``paged_prefill_chunk_tiled_torch`` repeats its blocks
of 64 query rows, their tiles (64 keys, 32 at D 256, spanning pages) and the
runs it cuts them into, its online softmax across them and,
over intN pools, its scale folding (integer pages, each key's (page, head)
scale on its column of S for K and of P for V). It is held against the
reference's chunk kernels (``paged_prefill_chunk{,_quant}_jnp`` and the
Pallas ``paged_flash_prefill_chunk{,_quant}`` in interpret mode) at rtol/atol
2e-5 (f32), at cursor 0, a cursor of exactly one page, tiles that cross
pages of different scales, and C 5, 128 and 256. The CUDA kernels are held
against the plain versions on the card (test_torch_kernels_cuda.py).
"""
import functools
import math

import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.accessors import QuantizedAccessor as JaxQuantizedAccessor
from repro.core.distributed import quantize_array as jax_quantize_array
from repro.kernels import ref as jref
from repro.kernels.paged_attention import (
    paged_flash_prefill_chunk as jax_flash_chunk,
    paged_flash_prefill_chunk_quant as jax_flash_chunk_quant,
    paged_prefill_chunk_jnp,
    paged_prefill_chunk_quant_jnp,
)
from repro.kernels.quant_matmul import quant_matmul as jax_quant_matmul
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm

TOL = dict(rtol=2e-5, atol=2e-5)
H100_SMS = 132


# =====================================================================================
# quant_matmul: the planner and the scheduled twin
# =====================================================================================
def _qmm_inputs(m, n, k, qblock, bits):
    rng = np.random.default_rng(m * 31 + n + k + bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32) / np.sqrt(k)
    bufs = jax_quantize_array(jnp.asarray(w), JaxQuantizedAccessor(jnp.float32, bits=bits,
                                                                   block=qblock))
    return x, np.array(bufs["q"]), np.array(bufs["scale"])


M_ROWS = [1, 8, 13, 16, 17, 128, 130]
NK_SHAPES = [(896, 4864), (4864, 896), (130, 896)]  # w_down, w_gate/w_up, N off every tile
X_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


@pytest.mark.parametrize("m", M_ROWS)
@pytest.mark.parametrize("nk", NK_SHAPES, ids=["n896", "n4864", "n130"])
@pytest.mark.parametrize("x_dtype", list(X_DTYPES))
@pytest.mark.parametrize("bits", [8, 4])
def test_scheduled_twin_matches_reference(m, nk, x_dtype, bits):
    """The twin of the schedule the kernel takes for x in ``x_dtype`` (the
    arithmetic in f32 on the same f32 x) against ref.quant_matmul."""
    n, k = nk
    x, q, scale = _qmm_inputs(m, n, k, 128, bits)
    plan = tqm.plan_quant_matmul(m, n, k, 128, bits, X_DTYPES[x_dtype], H100_SMS)
    if x_dtype == "bf16":
        assert plan.schedule == ("stream" if m <= 16 else "mma")
    else:
        assert plan.schedule == "fma"
    want = jref.quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), bits=bits)
    got = tqm.quant_matmul_torch(*map(torch.from_numpy, (x, q, scale)), bits=bits, plan=plan)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (M, N, K, qblock): an uneven K split (896 = 512 + 384 at decode), K of one
# block, N off every tile, a chunk schedule over five splits
PALLAS_CASES = [(8, 4864, 896, 128), (1, 896, 128, 128), (17, 896, 128, 128),
                (130, 130, 896, 128), (128, 896, 4864, 128), (13, 256, 192, 64)]


@pytest.mark.parametrize("case", PALLAS_CASES, ids=[f"case{i}" for i in range(len(PALLAS_CASES))])
@pytest.mark.parametrize("bits", [8, 4])
def test_scheduled_twin_matches_pallas_interpret(case, bits):
    m, n, k, qblock = case
    x, q, scale = _qmm_inputs(m, n, k, qblock, bits)
    block_n = 128 if n % 128 == 0 else n
    want = jax_quant_matmul(jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), bits=bits,
                            block_n=block_n, interpret=True)
    for dtype in X_DTYPES.values():
        plan = tqm.plan_quant_matmul(m, n, k, qblock, bits, dtype, H100_SMS)
        got = tqm.quant_matmul_torch(*map(torch.from_numpy, (x, q, scale)), bits=bits, plan=plan)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# (N, K, qblock): the MLP's shapes at three blocks, K of one block, K of three
PLAN_SHAPES = [(n, k, qb) for n, k in NK_SHAPES for qb in (32, 64, 128)] + [
    (896, 128, 128), (896, 128, 32), (70, 96, 32)]


@pytest.mark.parametrize("m", M_ROWS)
@pytest.mark.parametrize("nkq", PLAN_SHAPES, ids=str)
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("aligned", [True, False])
def test_plan_invariants(m, nkq, bits, aligned):
    """The split covers K once in runs of whole blocks (and of whole 64-value
    K-steps for mma, 256-value warp slices for stream); the schedule follows
    M, x's type, the block and alignment; for mma and fma at least half the
    splits that would give the card its blocks, where K has that many
    units."""
    n, k, qblock = nkq
    for dtype in X_DTYPES.values():
        p = tqm.plan_quant_matmul(m, n, k, qblock, bits, dtype, H100_SMS, aligned)
        assert (p.splits - 1) * p.k_per_split < k <= p.splits * p.k_per_split
        assert p.k_per_split % qblock == 0
        span = 64 if bits == 8 else 128
        if m <= 16 and dtype == torch.bfloat16 and aligned and qblock % span == 0:
            assert p.schedule == "stream" and p.k_per_split % 256 == 0
            # a block takes at most 16 warps of 256 values; more splits only past that
            assert p.k_per_split <= 16 * 256 * max(1, math.lcm(qblock, 256) // 256)
            assert p.splits == 1 or p.k_per_split > 8 * 256
            continue
        if m > 16 and dtype == torch.bfloat16 and aligned:
            assert p.schedule == "mma" and (p.splits == 1 or p.k_per_split % 64 == 0)
            blocks = -(-n // 64) * -(-m // 32) * p.splits
        else:  # f32, misaligned, or a block the stream span does not divide
            assert p.schedule == "fma"
            blocks = -(-n // 64) * -(-m // (16 if m <= 16 else 64)) * p.splits
        unit = math.lcm(qblock, {"mma": 64, "fma": qblock}[p.schedule])
        # the splits the card wants (blocks for ~2 a SM, 1 for fma), at most one a
        # unit; rounding runs up to whole units keeps at least half of them
        tiles = blocks // p.splits
        want = min(-(-(1 if p.schedule == "fma" else 2) * H100_SMS // tiles), -(-k // unit))
        assert 2 * p.splits >= want


def test_plan_at_the_mlp_shapes():
    """w_gate/w_up and w_down at 8 decode rows and one 128-token chunk (bf16)."""
    bf = torch.bfloat16
    assert tqm.plan_quant_matmul(8, 4864, 896, 128, 8, bf, H100_SMS) == ("stream", 1, 1024)
    assert tqm.plan_quant_matmul(8, 896, 4864, 128, 8, bf, H100_SMS) == ("stream", 2, 2560)
    assert tqm.plan_quant_matmul(8, 896, 4864, 128, 8, torch.float32, H100_SMS) == \
        ("fma", 10, 512)
    assert tqm.plan_quant_matmul(128, 4864, 896, 128, 8, bf, H100_SMS) == ("mma", 1, 896)
    assert tqm.plan_quant_matmul(128, 896, 4864, 128, 8, bf, H100_SMS) == ("mma", 5, 1024)


def test_twin_without_a_plan_is_the_plain_version():
    x, q, scale = map(torch.from_numpy, _qmm_inputs(8, 256, 256, 64, 8))
    plain = tqm.quant_matmul_torch(x, q, scale)
    one = tqm.QmmPlan("fma", 1, 256)
    np.testing.assert_allclose(tqm.quant_matmul_torch(x, q, scale, plan=one).numpy(),
                               plain.numpy(), **TOL)


# =====================================================================================
# the bf16 chunk body's tiles and scale folding
# =====================================================================================
def _pool(rng, num_pages, hkv, ps, d, bits):
    dq = d if bits == 8 else d // 2
    lo, hi = (-127, 128) if bits == 8 else (-128, 128)  # any byte is two int4 values
    q = rng.integers(lo, hi, size=(num_pages, hkv, ps, dq)).astype(np.int8)
    # scales spread over a decade and more (values up to ~2.5, as K/V pages
    # hold), so the pages inside one tile differ
    scale = (10.0 ** rng.uniform(-3, -1.7, size=(num_pages, hkv))).astype(np.float32)
    return q, scale


# (hq, hkv, d, ps, C, max_pages, cursors): cursor 0, exactly one page, tiles
# of 64 keys crossing pages of 4 and 16 (each its own scale), C 5, 128, 256
CHUNK_CASES = [(4, 2, 16, 4, 5, 20, (0, 4)), (14, 2, 64, 16, 128, 24, (16, 256)),
               (6, 2, 32, 4, 256, 40, (0, 150)), (8, 2, 64, 16, 5, 8, (16, 100))]
CHUNK_IDS = ["c5_ps4", "c128_serve", "c256_ps4", "c5_one_page"]


def _chunk_inputs(hq, hkv, d, ps, c, max_pages, cursors, bits):
    num_pages = 2 * max_pages + 1
    rng = np.random.default_rng(c * 3 + d + (bits or 0))
    q = rng.standard_normal((2, hq, c, d)).astype(np.float32)
    ck = rng.standard_normal((2, hkv, c, d)).astype(np.float32)
    cv = rng.standard_normal((2, hkv, c, d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(2, max_pages).astype(np.int32)
    cur = np.asarray(cursors, np.int32)
    if bits is None:
        kp = rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
        vp = rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
        return (q, ck, cv, kp, vp, bt, cur)
    kq, ks = _pool(rng, num_pages, hkv, ps, d, bits)
    vq, vs = _pool(rng, num_pages, hkv, ps, d, bits)
    return (q, ck, cv, kq, ks, vq, vs, bt, cur)


def _tiled(arrays, bits):
    t = [torch.from_numpy(a) for a in arrays]
    if bits is None:
        return tpa.paged_prefill_chunk_tiled_torch(*t)
    q, ck, cv, kq, ks, vq, vs, bt, cur = t
    return tpa.paged_prefill_chunk_tiled_torch(q, ck, cv, kq, vq, bt, cur, k_scale=ks,
                                               v_scale=vs, bits=bits)


def _reference(arrays, bits, which):
    a = [jnp.asarray(x) for x in arrays]
    if bits is None:
        fn = paged_prefill_chunk_jnp if which == "jnp" else functools.partial(
            jax_flash_chunk, interpret=True)
        return fn(*a)
    fn = paged_prefill_chunk_quant_jnp if which == "jnp" else functools.partial(
        jax_flash_chunk_quant, interpret=True)
    return fn(*a, bits=bits)


@pytest.mark.parametrize("case", CHUNK_CASES, ids=CHUNK_IDS)
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "int8", "int4"])
@pytest.mark.parametrize("reference", ["jnp", "pallas"])
def test_tiled_chunk_twin_matches_reference(case, bits, reference):
    arrays = _chunk_inputs(*case, bits)
    want = _reference(arrays, bits, reference)
    got = _tiled(arrays, bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_tiles_cross_pages_of_different_scales():
    """The c256_ps4 case puts 16 pages of 4 keys in each 64-key tile; their
    scales differ, so a twin applying one scale a tile would fail."""
    hq, hkv, d, ps, c, max_pages, cursors = CHUNK_CASES[2]
    arrays = _chunk_inputs(hq, hkv, d, ps, c, max_pages, cursors, 8)
    ks, bt = arrays[4], arrays[7]
    tile = tpa.chunk_tile_keys(d)
    first = ks[bt[1, :tile // ps], 0]
    assert tile // ps > 1 and len(set(first.tolist())) == tile // ps


@pytest.mark.parametrize("tile", [16, 64, 100])
def test_tiled_twin_does_not_depend_on_the_tile(tile):
    arrays = _chunk_inputs(*CHUNK_CASES[1], 4)
    t = [torch.from_numpy(a) for a in arrays]
    q, ck, cv, kq, ks, vq, vs, bt, cur = t
    got = tpa.paged_prefill_chunk_tiled_torch(q, ck, cv, kq, vq, bt, cur, k_scale=ks,
                                              v_scale=vs, bits=4, tile=tile)
    want = tpa.paged_prefill_chunk_quant_torch(*t, bits=4)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


@pytest.mark.parametrize("case", CHUNK_CASES, ids=CHUNK_IDS)
@pytest.mark.parametrize("bits", [None, 8, 4], ids=["dense", "int8", "int4"])
@pytest.mark.parametrize("splits", [2, 5, 40])
def test_tiled_chunk_twin_in_runs_matches_reference(case, bits, splits):
    """Each 64-row block's tiles cut into runs as the kernel cuts them, each
    run's partial merged by log-sum-exp (40 runs leave some empty), against
    the jnp reference at rtol/atol 2e-5."""
    arrays = _chunk_inputs(*case, bits)
    want = _reference(arrays, bits, "jnp")
    t = [torch.from_numpy(a) for a in arrays]
    if bits is None:
        got = tpa.paged_prefill_chunk_tiled_torch(*t, splits=splits)
    else:
        q, ck, cv, kq, ks, vq, vs, bt, cur = t
        got = tpa.paged_prefill_chunk_tiled_torch(q, ck, cv, kq, vq, bt, cur, k_scale=ks,
                                                  v_scale=vs, bits=bits, splits=splits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("batch,hq,hkv,c,d", [(1, 14, 2, 128, 64), (8, 14, 2, 5, 64),
                                              (8, 14, 2, 16, 64), (8, 14, 2, 256, 64),
                                              (2, 10, 1, 37, 256), (64, 32, 8, 64, 128)])
def test_chunk_split_plan(batch, hq, hkv, c, d):
    """One run for f32 and where the 64-row blocks give the card one and a
    half a SM; otherwise about that many, never more runs than tiles of the
    longest past plus the chunk, and never past the combine's 65535 rows."""
    max_pages, ps = 128, 16
    assert tpa.plan_chunk_splits(batch, hq, hkv, c, d, max_pages, ps, torch.float32,
                                 H100_SMS) == 1
    s = tpa.plan_chunk_splits(batch, hq, hkv, c, d, max_pages, ps, torch.bfloat16, H100_SMS)
    blocks = -(-c * (hq // hkv) // 64) * hkv * batch
    nk = tpa.chunk_tile_keys(d)
    assert 1 <= s <= min(tpa.MAX_CHUNK_SPLITS, -(-max_pages * ps // nk) + -(-c // nk))
    if batch * hq * c > 65535:
        assert s == 1
    else:
        assert (s == 1) == (2 * blocks >= 3 * H100_SMS)
        assert 2 * s * blocks >= 3 * H100_SMS or s == tpa.MAX_CHUNK_SPLITS
