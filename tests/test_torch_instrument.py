"""repro_torch.core.instrument against the JAX reference's, on the CPU.

CountingAccessor must tally what the reference's tallies (loads, stores and
the bytes each wrapped accessor prices), and ``counted_paged_decode`` must
give the reference's output and measured bytes for f32, int8 and int4 pools
(the intN pools through ``PagedQuantSpec.as_flat_accessor``), from the same
numpy inputs. Outputs compare at rtol/atol 1e-5, the reference test's bound
against its kernel twin; byte tallies are integers and compare exactly.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import accessors as JA
from repro.core import instrument as JI
from repro_torch.core import accessors as TA
from repro_torch.core import instrument as TI
from repro_torch.kernels.paged_attention import paged_decode_attention_quant_torch
from repro_torch.kernels.paged_attention import paged_decode_attention_torch
from repro_torch.serving.engine.kvquant import KV_DTYPES
from repro.serving.engine.kvquant import KV_DTYPES as JAX_KV_DTYPES


@pytest.mark.parametrize("build,offs", [
    (lambda m: m.BasicAccessor(), [np.arange(10), 3]),
    (lambda m: m.BitPackedAccessor(), [np.arange(8), np.arange(16), np.array([0, 8, 64])]),
    (lambda m: m.QuantizedAccessor(bits=8, block=16),
     [np.arange(10), np.array([0, 16]), np.array([0, 1, 15, 16])]),
    (lambda m: m.QuantizedAccessor(bits=4, block=16), [np.array([0, 1]), np.array([0, 2])]),
    (lambda m: m.Int4SplitHalfAccessor(bits=4, block=16, row=8),
     [np.array([0, 4]), np.array([0, 1, 8]), np.arange(32)]),
], ids=["basic", "bitpacked", "quant8", "quant4", "splithalf"])
def test_bytes_for_offsets_match_reference(build, offs):
    got, want = build(TA), build(JA)
    for o in offs:
        assert got.bytes_for_offsets(o) == want.bytes_for_offsets(o)
        if isinstance(o, np.ndarray):
            assert got.bytes_for_offsets(torch.from_numpy(o)) == want.bytes_for_offsets(o)


def test_bf16_basic_accessor_prices_two_bytes():
    assert TA.BasicAccessor(torch.bfloat16).bytes_for_offsets(np.arange(10)) == 20


def test_counting_accessor_delegates_and_tallies():
    acc = TI.CountingAccessor(TA.BasicAccessor())
    buffers = acc.from_codomain(np.arange(16.0), "cpu")  # encode is not an access
    assert acc.tally.loads == 0 and acc.tally.bytes_moved == 0
    np.testing.assert_allclose(acc.access(buffers, np.array([1, 3, 5])).numpy(), [1.0, 3.0, 5.0])
    assert (acc.tally.loads, acc.tally.bytes_loaded) == (3, 12)
    buffers = acc.store(buffers, torch.tensor([0, 2]), torch.tensor([9.0, 9.0]))
    assert float(buffers[0]) == 9.0
    assert (acc.tally.stores, acc.tally.bytes_stored, acc.tally.bytes_moved) == (2, 8, 20)
    assert acc.offset_policy is acc  # rebased views keep counting into the SAME tally
    shared = TI.TrafficTally()
    k_acc, v_acc = TI.CountingAccessor(TA.BasicAccessor(), shared), TI.CountingAccessor(
        TA.BasicAccessor(), shared)
    k_acc.access(k_acc.from_codomain(np.zeros(8), "cpu"), np.arange(4))
    v_acc.access(v_acc.from_codomain(np.zeros(8), "cpu"), np.arange(4))
    assert (shared.loads, shared.bytes_loaded) == (8, 32)
    shared.reset()
    assert shared.loads == shared.bytes_moved == 0


def test_flat_pool_offsets_match_reference():
    pages = np.array([5, 0, 2])
    got = TI.flat_pool_offsets(pages, 2, 4, 3, device="cpu")
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), JI.flat_pool_offsets(pages, 2, 4, 3))
    assert TI.flat_pool_offsets(torch.from_numpy(pages), 2, 4, 3).device.type == "cpu"


def _paged_case(seed, *, b, hq, hkv, d, ps, num_pages, max_pages, lens):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, 1, d)).astype(np.float32)
    pool_k = rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
    pool_v = rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
    tables = rng.permutation(num_pages)[: b * max_pages].reshape(b, max_pages).astype(np.int32)
    return q, pool_k, pool_v, tables, np.asarray(lens, np.int32)


@pytest.mark.parametrize("kv", ["f32", "int8", "int4"])
def test_counted_paged_decode_matches_reference(kv):
    hkv, d, ps, num_pages = 2, 16, 8, 16
    lens = [29, 0, 9, 17]
    q, pk, pv, tables, ctx = _paged_case(len(kv), b=4, hq=4, hkv=hkv, d=d, ps=ps,
                                         num_pages=num_pages, max_pages=4, lens=lens)
    if kv == "f32":
        t_inner, j_inner = TA.BasicAccessor(), JA.BasicAccessor()
    else:
        t_inner = KV_DTYPES[kv].as_flat_accessor(ps, d)
        j_inner = JAX_KV_DTYPES[kv].as_flat_accessor(ps, d)
    t_acc, j_acc = TI.CountingAccessor(t_inner), JI.CountingAccessor(j_inner)
    tk, tv = (t_inner.from_codomain(x.reshape(-1), "cpu") for x in (pk, pv))
    jk, jv = (j_inner.from_codomain(jnp.asarray(x.reshape(-1))) for x in (pk, pv))
    got, t_tally = TI.counted_paged_decode(
        torch.from_numpy(q), tk, tv, t_acc, torch.from_numpy(tables), torch.from_numpy(ctx),
        pool_shape=(num_pages, hkv, ps, d))
    want, j_tally = JI.counted_paged_decode(q, jk, jv, j_acc, tables, ctx,
                                            pool_shape=(num_pages, hkv, ps, d))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
    assert not got[1].any()  # a zero-length row gives exact zeros
    assert (t_tally.loads, t_tally.stores, t_tally.bytes_loaded) == (
        j_tally.loads, j_tally.stores, j_tally.bytes_loaded)
    live = sum(-(-n // ps) for n in lens)
    assert t_tally.loads == 2 * live * hkv * ps * d
    # the counted decode replays the port's plain decode over the same pool
    args = (torch.from_numpy(tables), torch.from_numpy(ctx))
    if kv == "f32":
        plain = paged_decode_attention_torch(torch.from_numpy(q), torch.from_numpy(pk),
                                             torch.from_numpy(pv), *args)
    else:
        shape = (num_pages, hkv, ps, -1)
        plain = paged_decode_attention_quant_torch(
            torch.from_numpy(q), tk["q"].reshape(shape), tk["scale"].reshape(num_pages, hkv),
            tv["q"].reshape(shape), tv["scale"].reshape(num_pages, hkv), *args,
            bits=int(kv[3:]))
    torch.testing.assert_close(got, plain, rtol=1e-5, atol=1e-5)
