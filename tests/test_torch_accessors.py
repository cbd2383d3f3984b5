"""repro_torch.core accessors against the JAX reference's, on the CPU.

Every accessor encodes the same numpy codomain in both packages:
``from_codomain`` must give the same bytes and scales, and ``access`` /
``store`` / ``decay`` the same values. ``store`` is functional in both: it
returns new buffers and leaves its input as it was. The reference's laws
(tests/test_accessors.py) are held on the port: round trip, access, store,
offset, accumulate linearity, memory-space typing. The tail-offset store law
is drawn here with f32-exact hypothesis bounds (the reference test passes an
f64 product as a width-32 bound, which hypothesis refuses).
"""
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")
hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st

import repro.core.accessors as JA
import repro_torch.core.accessors as TA
from repro_torch.serving.engine.kvquant import KV_DTYPES
from repro.serving.engine.kvquant import KV_DTYPES as JAX_KV_DTYPES

PKGS = {"jax": JA, "torch": TA}
DT = {"jax": {"f32": jnp.float32, "bf16": jnp.bfloat16, "bool": jnp.bool_},
      "torch": {"f32": torch.float32, "bf16": torch.bfloat16, "bool": torch.bool}}


def arr(pkg, x):
    return jnp.asarray(x) if pkg == "jax" else torch.from_numpy(np.ascontiguousarray(x))


def npy(a):
    if isinstance(a, dict):
        return {k: npy(v) for k, v in a.items()}
    if isinstance(a, torch.Tensor):
        return a.float().numpy() if a.dtype == torch.bfloat16 else a.numpy()
    a = np.asarray(a)
    return a.astype(np.float32) if a.dtype == jnp.bfloat16 else a


def assert_same(got, want):
    got, want = npy(got), npy(want)
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_same(got[k], want[k])
        return
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def clone(b):
    return {k: clone(v) for k, v in b.items()} if isinstance(b, dict) else b.clone()


def _quant(p, bits, block):
    return PKGS[p].QuantizedAccessor(DT[p]["f32"], bits=bits, block=block)


# case -> (build(pkg) -> accessor, codomain kind, span)
ACCESSOR_CASES = {
    "basic_f32": (lambda p: PKGS[p].BasicAccessor(DT[p]["f32"]), "f32", 20),
    "basic_bf16": (lambda p: PKGS[p].BasicAccessor(DT[p]["bf16"]), "f32", 20),
    "restrict": (lambda p: PKGS[p].RestrictAccessor(DT[p]["f32"]), "f32", 9),
    "accumulate": (lambda p: PKGS[p].AccumulateAccessor(DT[p]["f32"]), "f32", 12),
    "bitpacked": (lambda p: PKGS[p].BitPackedAccessor(), "bool", 21),
    "quant8_block8": (lambda p: _quant(p, 8, 8), "f32", 21),
    "quant4_block8": (lambda p: _quant(p, 4, 8), "f32", 21),
    "quant4_odd_block": (lambda p: _quant(p, 4, 5), "f32", 22),
    "quant8_bf16": (lambda p: PKGS[p].QuantizedAccessor(DT[p]["bf16"], bits=8, block=4), "f32", 16),
    "splithalf": (lambda p: PKGS[p].Int4SplitHalfAccessor(DT[p]["f32"], bits=4, block=16, row=8),
                  "f32", 32),
    "memspace": (lambda p: PKGS[p].MemorySpaceAccessor(DT[p]["f32"], PKGS[p].MemorySpace.HBM),
                 "f32", 10),
    "host_tier_basic": (lambda p: PKGS[p].HostTierAccessor(PKGS[p].BasicAccessor(DT[p]["f32"]),
                                                           page_elems=4, host_pages=(1, 3)),
                        "f32", 16),
    "host_tier_quant": (lambda p: PKGS[p].HostTierAccessor(
        PKGS[p].QuantizedAccessor(DT[p]["f32"], bits=8, block=4), page_elems=8, host_pages=(0,)),
        "f32", 16),
}


def _codomain(kind, span, seed):
    rng = np.random.default_rng(seed)
    if kind == "bool":
        return rng.random(span) < 0.5
    return (rng.standard_normal(span) * 3).astype(np.float32)


def _encode(p, acc, dense):
    return acc.from_codomain(arr(p, dense)) if p == "jax" else acc.from_codomain(dense, "cpu")


@pytest.mark.parametrize("case", sorted(ACCESSOR_CASES))
def test_accessor_matches_reference(case):
    build, kind, span = ACCESSOR_CASES[case]
    acc = {p: build(p) for p in PKGS}
    dense = _codomain(kind, span, len(case))
    bufs = {p: _encode(p, acc[p], dense) for p in PKGS}
    assert_same(bufs["torch"], bufs["jax"])  # bytes and scales, bit for bit
    if "host_tier" in case:  # the host set starts cold: warm it through a store
        offs = np.arange(span)
        bufs = {p: acc[p].store(bufs[p], arr(p, offs), arr(p, dense)) for p in PKGS}
        assert_same(bufs["torch"], bufs["jax"])
    dec = {p: acc[p].decay(bufs[p]) for p in PKGS}
    assert_same(dec["torch"], dec["jax"])
    offs = np.array([0, span // 2, span - 1, 1, span // 2], np.int64)
    assert_same(acc["torch"].access(bufs["torch"], torch.from_numpy(offs)),
                acc["jax"].access(bufs["jax"], jnp.asarray(offs)))
    assert_same(acc["torch"].access(bufs["torch"], span - 1),
                acc["jax"].access(bufs["jax"], span - 1))
    # stores: a batch (distinct offsets) and a scalar, the input left as it was
    vals = _codomain(kind, 3, 7)
    st_offs = np.array([0, span // 2, span - 1], np.int64)
    before = clone(bufs["torch"])
    out = {p: acc[p].store(bufs[p], arr(p, st_offs), arr(p, vals)) for p in PKGS}
    assert_same(out["torch"], out["jax"])
    assert_same(bufs["torch"], before)
    out = {p: acc[p].store(out[p], 1, vals[0]) for p in PKGS}
    assert_same(out["torch"], out["jax"])
    assert acc["torch"].bytes_for_offsets(offs) == acc["jax"].bytes_for_offsets(offs)


def test_accumulate_linearity():
    """The atomic-accessor law: order-independent accumulation."""
    acc = TA.AccumulateAccessor(torch.float32)
    buf = acc.from_codomain(torch.zeros(4))
    buf = acc.store(buf, torch.tensor([1, 1, 2, 1]), torch.tensor([1.0, 2.0, 5.0, 4.0]))
    np.testing.assert_allclose(acc.decay(buf).numpy(), [0.0, 7.0, 5.0, 0.0])


@pytest.mark.parametrize("acc", [TA.BasicAccessor(torch.float32),
                                 TA.QuantizedAccessor(torch.float32, bits=8, block=4),
                                 TA.QuantizedAccessor(torch.float32, bits=4, block=4)],
                         ids=["basic", "quant8", "quant4"])
def test_accessor_offset_law(acc):
    bufs = acc.from_codomain(torch.arange(16, dtype=torch.float32))
    p2 = acc.offset(bufs, 4)
    assert float(acc.offset_policy.access(p2, 0)) == float(acc.access(bufs, 4))
    with pytest.raises(TypeError):
        TA.QuantizedAccessor(bits=8, block=4).offset(bufs, 3)


def test_packed_accessors_reject_negative_offsets():
    for acc in (TA.QuantizedAccessor(bits=4, block=8), TA.BitPackedAccessor()):
        bufs = acc.alloc(9, "cpu")
        with pytest.raises(TypeError):
            acc.access(bufs, -1)
        with pytest.raises(TypeError):
            acc.store(bufs, -1, 1)
    with pytest.raises(ValueError):
        TA.QuantizedAccessor(bits=3)
    with pytest.raises(ValueError):
        TA.Int4SplitHalfAccessor(bits=4, block=12, row=8)


def test_memory_space_strong_typing():
    a = TA.MemorySpaceAccessor(torch.float32, TA.MemorySpace.VMEM)
    b = TA.MemorySpaceAccessor(torch.float32, TA.MemorySpace.HBM)
    c = TA.MemorySpaceAccessor(torch.float32, TA.MemorySpace.ANY)
    with pytest.raises(TypeError):
        TA.require_same_space(a, b)
    TA.require_same_space(a, c)  # ANY unifies
    assert a.offset_policy.space == TA.MemorySpace.ANY
    assert b.offset_policy.space == TA.MemorySpace.HBM


def test_host_tier_migrate_matches_reference():
    dense = _codomain("f32", 16, 3)
    accs = {p: PKGS[p].HostTierAccessor(PKGS[p].BasicAccessor(DT[p]["f32"]), page_elems=4)
            for p in PKGS}
    bufs = {p: _encode(p, accs[p], dense) for p in PKGS}
    for page, to in [(1, "HOST"), (3, "HOST"), (1, "HBM"), (1, "HBM")]:
        for p in PKGS:
            bufs[p], accs[p] = accs[p].migrate(bufs[p], page, getattr(PKGS[p].MemorySpace, to))
        assert accs["torch"].host_pages == accs["jax"].host_pages
        assert_same(bufs["torch"], bufs["jax"])
        assert_same(accs["torch"].decay(bufs["torch"]), dense)
    assert accs["torch"].space_for_offset(13) == TA.MemorySpace.HOST


@pytest.mark.parametrize("bits", [8, 4])
def test_kvquant_flat_accessor_matches_reference(bits):
    ps, d = 4, 8
    got = KV_DTYPES[f"int{bits}"].as_flat_accessor(ps, d)
    want = JAX_KV_DTYPES[f"int{bits}"].as_flat_accessor(ps, d)
    assert type(got).__name__ == type(want).__name__
    assert (got.bits, got.block, getattr(got, "row", None)) == (
        want.bits, want.block, getattr(want, "row", None))
    # the pool encoder's pages, flattened, ARE the flat accessor's buffers
    pool = np.random.default_rng(bits).standard_normal((3, 2, ps, d)).astype(np.float32)
    enc = KV_DTYPES[f"int{bits}"].encode_pages(torch.from_numpy(pool))
    flat = got.from_codomain(torch.from_numpy(pool.reshape(-1)))
    assert torch.equal(enc["q"].reshape(-1), flat["q"])
    assert torch.equal(enc["scale"].reshape(-1), flat["scale"])


def _f32_toward_zero(x: float) -> float:
    """The f32 nearest ``x`` that is no farther from 0 than ``x``."""
    f = np.float32(x)
    if abs(float(f)) > abs(x):
        f = np.nextafter(f, np.float32(0))
    return float(f)


@settings(max_examples=30, deadline=None)
@given(st.integers(1, 2), st.integers(-1, 1), st.sampled_from([4, 8]), st.data())
def test_quantized_store_roundtrip_at_tail_offsets(nblocks, delta, bits, data):
    """store/access at the first and last offsets around block boundaries:
    the written value reads back within half a step of the block's existing
    scale and every other offset is untouched (the reference test's law),
    with the value drawn between f32-exact bounds."""
    block = 8
    span = max(1, nblocks * block + delta)
    vals = data.draw(st.lists(st.floats(-50, 50, allow_nan=False, width=32),
                              min_size=span, max_size=span))
    acc = TA.QuantizedAccessor(torch.float32, bits=bits, block=block)
    bufs = acc.from_codomain(np.array(vals, np.float32), "cpu")
    before = acc.decay(bufs, span=span).numpy()
    for i in (0, span - 1):
        scale = float(bufs["scale"][i // block])
        bound = _f32_toward_zero(abs(scale) * acc.qmax)
        v = data.draw(st.floats(-bound, bound, allow_nan=False, width=32))
        kept = clone(bufs)
        b2 = acc.store(bufs, i, v)
        assert_same(bufs, kept)  # functional: the input is unmutated
        assert abs(float(acc.access(b2, i)) - v) <= max(scale, 1e-7) * 0.5 + 1e-5
        rest = acc.decay(b2, span=span).numpy()
        mask = np.arange(span) != i
        np.testing.assert_array_equal(rest[mask], before[mask])


@settings(max_examples=20, deadline=None)
@given(st.integers(1, 3), st.integers(-1, 1), st.sampled_from([4, 8]), st.integers(1, 9),
       st.data())
def test_quantized_roundtrip_at_block_boundaries(nblocks, delta, bits, block, data):
    """Round trip within half a step per block at spans on, under and over a
    block boundary; per-offset access equals the bulk decay at both tails."""
    span = max(1, nblocks * block + delta)
    xs = np.array(data.draw(st.lists(st.floats(-100, 100, allow_nan=False, width=32),
                                     min_size=span, max_size=span)), np.float32)
    acc = TA.QuantizedAccessor(torch.float32, bits=bits, block=block)
    bufs = acc.from_codomain(xs, "cpu")
    rec = acc.decay(bufs, span=span).numpy()
    nb = -(-span // block)
    step = np.abs(np.pad(xs, (0, nb * block - span)).reshape(nb, block)).max(axis=1) / acc.qmax
    bound = np.repeat(np.maximum(step, 1e-7), block)[:span] * 0.5 + 1e-5
    assert np.all(np.abs(rec - xs) <= bound)
    for i in {0, span // 2, span - 1}:
        assert float(acc.access(bufs, i)) == rec[i]


def test_quantized_store_clips_to_the_block_scale():
    acc = TA.QuantizedAccessor(torch.float32, bits=8, block=4)
    bufs = acc.from_codomain(torch.tensor([1.0, 2.0, 3.0, 4.0, 10.0, 20.0, 30.0, 40.0]))
    bufs = acc.store(bufs, 1, 3.5)
    assert abs(float(acc.access(bufs, 1)) - 3.5) <= 4.0 / 127 + 1e-6
    bufs = acc.store(bufs, 1, 1000.0)
    assert float(acc.access(bufs, 1)) <= 4.0 + 1e-6
