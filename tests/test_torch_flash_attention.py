"""repro_torch's dense attention (ops.attention / ops.decode_attention, the
plain versions beside the flash_attention and flash_decode CUDA kernels)
against the reference's Pallas kernels in interpret mode and its jnp twin.

The same numpy inputs, made from a seed, go through both packages. The sweeps
are the reference's (tests/test_kernels_lm.py): hq/hkv (4, 4), (4, 2), (8, 1);
causal, window 24, non-causal; a traced q_offset; decode at pos 0, 31, 57,
127. Tolerances are the reference's kernel-vs-oracle ones: f32 rtol 2e-4 /
atol 2e-5, bf16 3e-2.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import flash_decode as jdecode
from repro_torch import kernels
from repro_torch.kernels import flash_attention as tfa
from repro_torch.kernels import ops

F32 = dict(rtol=2e-4, atol=2e-5)
BF16 = dict(rtol=3e-2, atol=3e-2)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype) for a in arrays]


def _j(*arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (8, 1)])
@pytest.mark.parametrize("causal,window", [(True, None), (True, 24), (False, None)])
def test_attention_matches_pallas_kernel(hq, hkv, causal, window):
    rng = np.random.default_rng(hq * 10 + hkv)
    q, k, v = _normal(rng, (2, hq, 64, 32)), _normal(rng, (2, hkv, 64, 32)), \
        _normal(rng, (2, hkv, 64, 32))
    want = jflash(*_j(q, k, v), causal=causal, window=window, block_q=16, block_k=16)
    got = ops.attention(*_t(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    oracle = ref.attention(*_j(q, k, v), causal=causal, window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **F32)


@pytest.mark.parametrize("q_offset", [0, 5, 40])
@pytest.mark.parametrize("window", [None, 24])
def test_attention_traced_offset_matches_pallas_kernel(q_offset, window):
    """Tq != Tk with the queries at absolute positions q_offset + i, the
    offset handed to both as a traced / tensor scalar."""
    rng = np.random.default_rng(q_offset)
    q, k, v = _normal(rng, (1, 4, 16, 32)), _normal(rng, (1, 2, 64, 32)), \
        _normal(rng, (1, 2, 64, 32))
    want = jax.jit(lambda q, k, v, o: jflash(q, k, v, window=window, q_offset=o, block_q=8,
                                             block_k=16))(*_j(q, k, v), jnp.int32(q_offset))
    got = ops.attention(*_t(q, k, v), window=window, q_offset=torch.tensor(q_offset))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    np.testing.assert_allclose(
        got.numpy(),
        np.asarray(jops.attention_jnp(*_j(q, k, v), window=window, q_offset=q_offset)), **F32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_dtypes_match_pallas_kernel(dtype):
    rng = np.random.default_rng(3)
    q, k, v = _normal(rng, (1, 2, 32, 16)), _normal(rng, (1, 2, 48, 16)), \
        _normal(rng, (1, 2, 48, 16))
    want = jflash(*_j(q, k, v, dtype=getattr(jnp, dtype)), causal=False, block_q=8, block_k=16)
    got = ops.attention(*_t(q, k, v, dtype=getattr(torch, dtype)), causal=False)
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **(F32 if dtype == "float32" else BF16))


def test_fully_masked_rows_output_zeros():
    """Query rows before every key (negative positions) see nothing and
    output 0, as the Pallas kernel's l == 0 -> 1 rule gives when it skips
    every block of the row (block_q 1 here); the other rows equal the
    reference's kernel and its jnp twin. (The twin itself gives a fully
    masked row the mean of V; no model path has such a row.)"""
    rng = np.random.default_rng(4)
    q, k, v = _normal(rng, (1, 2, 4, 16)), _normal(rng, (1, 1, 8, 16)), _normal(rng, (1, 1, 8, 16))
    got = ops.attention(*_t(q, k, v), q_offset=-3)
    want = jflash(*_j(q, k, v), q_offset=-3, block_q=1, block_k=8)
    assert torch.count_nonzero(got[:, :, :3]) == 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    twin = jops.attention_jnp(*_j(q, k, v), q_offset=-3)
    np.testing.assert_allclose(got.numpy()[:, :, 3:], np.asarray(twin)[:, :, 3:], **F32)


@pytest.mark.parametrize("pos", [0, 31, 57, 127])
@pytest.mark.parametrize("window", [None, 24])
def test_decode_attention_matches_pallas_kernel(pos, window):
    B, Hq, Hkv, S, D = 2, 4, 2, 128, 32
    rng = np.random.default_rng(pos)
    kc, vc, q1 = _normal(rng, (B, Hkv, S, D)), _normal(rng, (B, Hkv, S, D)), \
        _normal(rng, (B, Hq, 1, D))
    want = jax.jit(lambda q, k, v, p: jdecode(q, k, v, p, window=window, block_k=32))(
        *_j(q1, kc, vc), jnp.int32(pos))
    for p in (pos, torch.tensor(pos, dtype=torch.int32), torch.tensor([pos])):
        got = ops.decode_attention(*_t(q1, kc, vc), p, window=window)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **F32)
    twin = jops.decode_attention(*_j(q1, kc, vc), jnp.int32(pos), window=window, impl="jnp")
    np.testing.assert_allclose(got.numpy(), np.asarray(twin), **F32)


def test_cpu_wrappers_return_the_plain_versions_and_launch_nothing():
    rng = np.random.default_rng(5)
    q, k, v = _t(_normal(rng, (1, 4, 8, 16)), _normal(rng, (1, 2, 8, 16)),
                 _normal(rng, (1, 2, 8, 16)))
    before = kernels.launch_counts()
    torch.testing.assert_close(tfa.flash_attention(q, k, v, window=3),
                               tfa.attention_torch(q, k, v, window=3), rtol=0, atol=0)
    torch.testing.assert_close(tfa.flash_decode(q[:, :, :1], k, v, 4),
                               tfa.decode_attention_torch(q[:, :, :1], k, v, 4), rtol=0, atol=0)
    assert kernels.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA"):
        ops.attention(q, k, v, impl="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        ops.decode_attention(q[:, :, :1], k, v, 4, impl="cuda")
