"""repro_torch's quantized pieces vs the JAX reference, on seeded numpy inputs.

Encoders (PagedQuantSpec, both int4 nibble orders, quantize_array) must give
the reference's bytes and scales bit for bit: both round x / scale half to
even in f32. The plain quantized attention and matmul versions are held
against the reference's jnp twins and its Pallas kernels in interpret mode at
rtol/atol 2e-5 (f32), the tolerance test_torch_paged_attention.py uses; they
sum in a different order, so they are not bit-equal. The CUDA kernels are
held against these plain versions in test_torch_kernels_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.core.accessors import QuantizedAccessor as JaxQuantizedAccessor
from repro.core.distributed import (
    dequantize_array as jax_dequantize_array,
    quantize_array as jax_quantize_array,
)
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.paged_attention import (
    pack_int4_splithalf as jax_pack_splithalf,
    paged_decode_attention_quant_jnp,
    paged_flash_decode_quant as jax_flash_decode_quant,
    paged_flash_prefill_chunk_quant as jax_flash_chunk_quant,
    paged_prefill_chunk_quant_jnp,
    unpack_int4_splithalf as jax_unpack_splithalf,
)
from repro.kernels.quant_matmul import quant_matmul as jax_quant_matmul
from repro.models.layers import fit_quant as jax_fit_quant
from repro.serving.engine.kvquant import KV_DTYPES as JAX_KV_DTYPES
from repro_torch import kernels
from repro_torch.core import QuantizedAccessor, dequantize_array, quantize_array
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa
from repro_torch.kernels import quant_matmul as tqm
from repro_torch.models.layers import fit_quant
from repro_torch.serving.engine import KV_DTYPES

TOL = dict(rtol=2e-5, atol=2e-5)
BITS = [8, 4]

REF_DECODE = {
    "jnp": paged_decode_attention_quant_jnp,
    "pallas": functools.partial(jax_flash_decode_quant, interpret=True),
}
REF_CHUNK = {
    "jnp": paged_prefill_chunk_quant_jnp,
    "pallas": functools.partial(jax_flash_chunk_quant, interpret=True),
}
REF_MATMUL = {
    "jnp": jref.quant_matmul,
    "pallas": functools.partial(jax_quant_matmul, interpret=True),
}


def _bits_equal(got: torch.Tensor, want) -> bool:
    want = np.asarray(want)
    got = got.numpy()
    if got.dtype == np.float32:
        return np.array_equal(got.view(np.uint32), want.view(np.uint32))
    return got.dtype == want.dtype and np.array_equal(got, want)


def _kv_values(rng, *shape):
    """K/V-like f32 values with an all-zero page and a few large outliers."""
    x = rng.standard_normal(shape).astype(np.float32)
    x[0] = 0.0
    x.reshape(-1)[::97] *= 40.0
    return x


# =====================================================================================
# encoders: bit-equal bytes and scales
# =====================================================================================
@pytest.mark.parametrize("bits", BITS)
def test_paged_quant_spec_matches_reference(bits):
    spec, jspec = KV_DTYPES[f"int{bits}"], JAX_KV_DTYPES[f"int{bits}"]
    rng = np.random.default_rng(bits)
    pages = _kv_values(rng, 3, 5, 2, 4, 16)  # (L, pages, Hkv, ps, D)
    got, want = spec.encode_pages(torch.from_numpy(pages)), jspec.encode_pages(pages)
    assert _bits_equal(got["q"], want["q"]) and _bits_equal(got["scale"], want["scale"])
    assert _bits_equal(spec.decode_pages(got["q"], got["scale"]),
                       jspec.decode_pages(want["q"], want["scale"]))
    tok = _kv_values(rng, 6, 2, 16)
    assert _bits_equal(spec.token_scale(torch.from_numpy(tok)), jspec.token_scale(tok))
    given = np.abs(rng.standard_normal((6, 2))).astype(np.float32) * 0.05
    given[0, 0] = 0.0  # an unset scale quantizes with 1.0
    assert _bits_equal(spec.quantize_tokens(torch.from_numpy(tok), torch.from_numpy(given)),
                       jspec.quantize_tokens(tok, given))
    assert spec.packed_dim(16) == jspec.packed_dim(16) and spec.qmax == jspec.qmax


def test_int4_splithalf_packing_matches_reference():
    vals = np.random.default_rng(0).integers(-8, 8, size=(4, 3, 16)).astype(np.int8)
    packed = tpa.pack_int4_splithalf(torch.from_numpy(vals))
    assert _bits_equal(packed, jax_pack_splithalf(jnp.asarray(vals)))
    assert _bits_equal(tpa.unpack_int4_splithalf(packed), jax_unpack_splithalf(jnp.asarray(
        packed.numpy())))
    np.testing.assert_array_equal(tpa.unpack_int4_splithalf(packed).numpy(), vals)


@pytest.mark.parametrize("bits,block", [(8, 64), (8, 128), (4, 64), (4, 128)])
def test_quantize_array_matches_reference(bits, block):
    x = _kv_values(np.random.default_rng(block + bits), 2, 6, 256)
    acc = QuantizedAccessor(torch.float32, bits=bits, block=block)
    jacc = JaxQuantizedAccessor(jnp.float32, bits=bits, block=block)
    got, want = quantize_array(torch.from_numpy(x), acc), jax_quantize_array(jnp.asarray(x), jacc)
    assert _bits_equal(got["q"], want["q"]) and _bits_equal(got["scale"], want["scale"])
    assert _bits_equal(dequantize_array(got, acc), jax_dequantize_array(want, jacc))


@pytest.mark.parametrize("block,d_in", [(128, 896), (128, 64), (128, 4864), (64, 96), (128, 20)])
def test_fit_quant_matches_reference(block, d_in):
    got = fit_quant(QuantizedAccessor(torch.float32, bits=8, block=block), d_in)
    want = jax_fit_quant(JaxQuantizedAccessor(jnp.float32, bits=8, block=block), d_in)
    assert (got is None) == (want is None)
    if got is not None:
        assert (got.block, got.bits, got.qmax) == (want.block, want.bits, want.qmax)


# =====================================================================================
# plain quantized attention vs the reference (jnp twin and Pallas interpret)
# =====================================================================================
def _pool(rng, num_pages, hkv, ps, d, bits):
    dq = d if bits == 8 else d // 2
    lo, hi = (-127, 128) if bits == 8 else (-128, 128)  # any byte is two int4 values
    q = rng.integers(lo, hi, size=(num_pages, hkv, ps, dq)).astype(np.int8)
    scale = (np.abs(rng.standard_normal((num_pages, hkv))) * 0.02 + 1e-3).astype(np.float32)
    return q, scale


def _decode_quant_inputs(batch, ps, lens, hq, hkv, d, bits):
    max_pages = max(1, -(-max(lens) // ps))
    num_pages = batch * max_pages + 1
    rng = np.random.default_rng(batch * 10 + bits)
    q = rng.standard_normal((batch, hq, 1, d)).astype(np.float32)
    kq, ks = _pool(rng, num_pages, hkv, ps, d, bits)
    vq, vs = _pool(rng, num_pages, hkv, ps, d, bits)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(batch, max_pages).astype(np.int32)
    return q, kq, ks, vq, vs, bt, np.asarray(lens, np.int32)


def _chunk_quant_inputs(hq, hkv, d, ps, c, max_pages, cursors, bits):
    num_pages = 2 * max_pages + 1
    rng = np.random.default_rng(c + bits)
    q = rng.standard_normal((2, hq, c, d)).astype(np.float32)
    ck = rng.standard_normal((2, hkv, c, d)).astype(np.float32)
    cv = rng.standard_normal((2, hkv, c, d)).astype(np.float32)
    kq, ks = _pool(rng, num_pages, hkv, ps, d, bits)
    vq, vs = _pool(rng, num_pages, hkv, ps, d, bits)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(2, max_pages).astype(np.int32)
    return q, ck, cv, kq, ks, vq, vs, bt, np.asarray(cursors, np.int32)


DECODE_CASES = [(2, 8, (5, 20), 4, 2, 16), (4, 16, (0, 16, 33, 70), 14, 2, 64)]
CHUNK_CASES = [(4, 2, 16, 4, 8, 6, (4, 8)), (14, 2, 64, 16, 16, 4, (0, 32))]


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", DECODE_CASES, ids=["g2d16", "g7d64"])
@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("bits", BITS)
def test_decode_quant_plain_matches_reference(case, reference, bits):
    arrays = _decode_quant_inputs(*case, bits)
    want = REF_DECODE[reference](*map(jnp.asarray, arrays), bits=bits)
    got = tpa.paged_decode_attention_quant_torch(*_t(*arrays), bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("case", CHUNK_CASES, ids=["g2d16", "g7d64"])
@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("bits", BITS)
def test_chunk_quant_plain_matches_reference(case, reference, bits):
    arrays = _chunk_quant_inputs(*case, bits)
    want = REF_CHUNK[reference](*map(jnp.asarray, arrays), bits=bits)
    got = tpa.paged_prefill_chunk_quant_torch(*_t(*arrays), bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# =====================================================================================
# quant_matmul vs the reference
# =====================================================================================
def _qmm_inputs(m, n, k, qblock, bits, seed=0):
    rng = np.random.default_rng(seed + m + bits)
    x = rng.standard_normal((m, k)).astype(np.float32)
    w = rng.standard_normal((n, k)).astype(np.float32) / np.sqrt(k)
    bufs = jax_quantize_array(jnp.asarray(w), JaxQuantizedAccessor(jnp.float32, bits=bits,
                                                                   block=qblock))
    return x, np.array(bufs["q"]), np.array(bufs["scale"])


@pytest.mark.parametrize("m,n,k,qblock", [(8, 256, 128, 64), (20, 128, 256, 128)])
@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("bits", BITS)
def test_quant_matmul_plain_matches_reference(m, n, k, qblock, reference, bits):
    x, q, scale = _qmm_inputs(m, n, k, qblock, bits)
    want = REF_MATMUL[reference](jnp.asarray(x), jnp.asarray(q), jnp.asarray(scale), bits=bits)
    got = tqm.quant_matmul_torch(*_t(x, q, scale), bits=bits)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("bits", BITS)
def test_ops_matmul_dispatches_quantized_buffers(bits):
    x, q, scale = _qmm_inputs(6, 128, 128, 64, bits)
    x3 = torch.from_numpy(x).reshape(2, 3, 128)
    w = {"q": torch.from_numpy(q), "scale": torch.from_numpy(scale)}
    acc = QuantizedAccessor(torch.float32, bits=bits, block=64)
    want = jops.matmul(jnp.asarray(x).reshape(2, 3, 128), {k: jnp.asarray(v.numpy())
                                                           for k, v in w.items()},
                       JaxQuantizedAccessor(jnp.float32, bits=bits, block=64), impl="jnp")
    for impl in ("auto", "torch"):
        got = ops.matmul(x3, w, acc, impl=impl)
        assert got.shape == (2, 3, 128)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    dense = torch.from_numpy(np.random.default_rng(1).standard_normal((128, 5)).astype(np.float32))
    torch.testing.assert_close(ops.matmul(x3, dense), x3 @ dense)


# =====================================================================================
# wrappers and dispatch on the CPU
# =====================================================================================
@pytest.mark.parametrize("bits", BITS)
def test_cpu_quant_wrappers_return_the_plain_versions(bits):
    before = kernels.launch_counts()
    dec = _t(*_decode_quant_inputs(*DECODE_CASES[0], bits))
    np.testing.assert_array_equal(
        tpa.paged_flash_decode_quant(*dec, bits=bits).numpy(),
        tpa.paged_decode_attention_quant_torch(*dec, bits=bits).numpy(),
    )
    np.testing.assert_array_equal(
        ops.paged_decode_attention_quant(*dec, bits=bits, block_pages=1).numpy(),
        tpa.paged_decode_attention_quant_torch(*dec, bits=bits).numpy(),
    )
    chunk = _t(*_chunk_quant_inputs(*CHUNK_CASES[0], bits))
    for got in (tpa.paged_flash_prefill_chunk_quant(*chunk, bits=bits),
                ops.paged_prefill_chunk_attention_quant(*chunk, bits=bits, impl="torch")):
        np.testing.assert_array_equal(
            got.numpy(), tpa.paged_prefill_chunk_quant_torch(*chunk, bits=bits).numpy())
    qmm = _t(*_qmm_inputs(8, 128, 128, 64, bits))
    np.testing.assert_array_equal(tqm.quant_matmul(*qmm, bits=bits).numpy(),
                                  tqm.quant_matmul_torch(*qmm, bits=bits).numpy())
    assert kernels.launch_counts() == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention_quant(*dec, bits=bits, impl="cuda")


def test_launch_counts_cover_every_kernel():
    assert set(kernels.launch_counts()) == {
        "paged_decode", "paged_prefill_chunk", "paged_decode_quant",
        "paged_prefill_chunk_quant", "quant_matmul", "sum3d", "stencil3d",
        "tinymatsum_static", "tinymatsum_dynamic", "matvec_right", "matvec_left",
        "flash_attention", "flash_decode", "ssd_scan", "rglru_scan", "flash_attention_bwd",
        "ssd_scan_bwd", "rglru_scan_bwd",
    }


def test_kernel_sources_export_the_wrapped_entries():
    csrc = tpa.__file__.rsplit("/", 1)[0] + "/csrc/"
    text = open(csrc + "paged_attention.cu").read()
    for name in ("repro_paged_decode_quant", "repro_paged_prefill_chunk_quant"):
        assert f"{name}(" in text
    text = open(csrc + "quant_matmul.cu").read()
    for name in ("repro_quant_matmul", "repro_cuda_error_string"):
        assert f"{name}(" in text
    text = open(csrc + "flash_attention.cu").read()
    for name in ("repro_flash_attention", "repro_flash_decode", "repro_cuda_error_string"):
        assert f"{name}(" in text
    text = open(csrc + "ssd_scan.cu").read()
    for name in ("repro_ssd_scan", "repro_cuda_error_string"):
        assert f"{name}(" in text
    for source, entry in (("ssd_scan_bwd.cu", "repro_ssd_scan_bwd"),
                          ("rglru_scan_bwd.cu", "repro_rglru_scan_bwd")):
        text = open(csrc + source).read()
        for name in (entry, "repro_geometry", "repro_cuda_error_string"):
            assert f"{name}(" in text
