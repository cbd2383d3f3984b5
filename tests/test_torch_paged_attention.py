"""repro_torch paged attention and sampling vs the JAX reference.

The same numpy inputs go through the port's plain PyTorch versions and the
reference's jnp twins and Pallas kernels (interpret mode), at rtol/atol 2e-5 —
the reference's own kernel-vs-oracle tolerance (f32). The CUDA kernels are
held against the plain versions in test_torch_kernels_cuda.py.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ops as jops
from repro.kernels.paged_attention import (
    paged_decode_attention_jnp,
    paged_flash_decode as jax_flash_decode,
    paged_flash_prefill_chunk as jax_flash_chunk,
    paged_prefill_chunk_jnp,
)
from repro_torch import kernels
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)

# the reference functions, each traced once per shape
REF_DECODE = {
    "jnp": jax.jit(paged_decode_attention_jnp),
    "pallas": jax.jit(functools.partial(jax_flash_decode, interpret=True)),
}
REF_CHUNK = {
    "jnp": jax.jit(paged_prefill_chunk_jnp),
    "pallas": jax.jit(functools.partial(jax_flash_chunk, interpret=True)),
}

# (batch, page_size, lens, hq, hkv, d): the reference's test shapes plus the
# qwen2-0.5b group (G = 7, D = 64) with a length-0 row and a one-page row
DECODE_CASES = [
    (2, 8, (5, 20), 4, 2, 16),
    (3, 16, (1, 16, 31), 4, 2, 16),
    (1, 4, (13,), 4, 2, 16),
    (4, 16, (0, 16, 33, 70), 14, 2, 64),
]

# (hq, hkv, d, ps, C, max_pages, cursors): the reference's chunk case, the
# G = 7 group with a cursor of 0, and a C = 5 window that is neither a power
# of two nor page-aligned (cursors mid-page)
CHUNK_CASES = [
    (4, 2, 16, 4, 8, 6, (4, 8)),
    (14, 2, 64, 16, 16, 4, (0, 32)),
    (14, 2, 16, 4, 5, 5, (3, 8)),
]


def _decode_inputs(batch, page_size, lens, hq, hkv, d, seed=None):
    max_pages = max(1, -(-max(lens) // page_size))
    num_pages = batch * max_pages + 1  # + null page 0
    rng = np.random.default_rng(seed if seed is not None else batch * 100 + page_size)
    q = rng.standard_normal((batch, hq, 1, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, hkv, page_size, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, hkv, page_size, d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(batch, max_pages).astype(np.int32)
    return q, kp, vp, bt, np.asarray(lens, np.int32)


def _chunk_inputs(hq, hkv, d, ps, c, max_pages, cursors, seed=0):
    num_pages = 2 * max_pages + 1
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((2, hq, c, d)).astype(np.float32)
    ck = rng.standard_normal((2, hkv, c, d)).astype(np.float32)
    cv = rng.standard_normal((2, hkv, c, d)).astype(np.float32)
    kp = rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
    vp = rng.standard_normal((num_pages, hkv, ps, d)).astype(np.float32)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(2, max_pages).astype(np.int32)
    return q, ck, cv, kp, vp, bt, np.asarray(cursors, np.int32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


def _j(*arrays):
    return [jnp.asarray(a) for a in arrays]


# =====================================================================================
# plain versions vs the reference (jnp twin and Pallas interpret)
# =====================================================================================
@pytest.mark.parametrize("case", DECODE_CASES, ids=lambda c: f"b{c[0]}ps{c[1]}g{c[3] // c[4]}d{c[5]}")
@pytest.mark.parametrize("reference", ["jnp", "pallas"])
@pytest.mark.parametrize("block_pages", [None, 2])
def test_decode_plain_matches_reference(case, reference, block_pages):
    arrays = _decode_inputs(*case)
    want = REF_DECODE[reference](*_j(*arrays))
    got = tpa.paged_decode_attention_torch(*_t(*arrays), block_pages=block_pages)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decode_length_zero_row_outputs_zeros():
    q, kp, vp, bt, lens = _decode_inputs(*DECODE_CASES[-1])
    out = tpa.paged_decode_attention_torch(*_t(q, kp, vp, bt, lens))
    assert lens[0] == 0 and torch.count_nonzero(out[0]) == 0


@pytest.mark.parametrize("case", CHUNK_CASES, ids=lambda c: f"g{c[0] // c[1]}d{c[2]}c{c[4]}")
@pytest.mark.parametrize("reference", ["jnp", "pallas"])
def test_chunk_plain_matches_reference(case, reference):
    arrays = _chunk_inputs(*case)
    want = REF_CHUNK[reference](*_j(*arrays))
    got = tpa.paged_prefill_chunk_torch(*_t(*arrays))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (True, 3, 0),
                                                    (False, None, 0), (True, None, 5)])
def test_attention_matches_reference(causal, window, q_offset):
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 6, 9, 16)).astype(np.float32)
    k = rng.standard_normal((2, 2, 14, 16)).astype(np.float32)
    v = rng.standard_normal((2, 2, 14, 16)).astype(np.float32)
    want = jops.attention_jnp(*_j(q, k, v), causal=causal, window=window, q_offset=q_offset,
                              block_k=4)
    got = ops.attention(*_t(q, k, v), causal=causal, window=window, q_offset=q_offset,
                        block_k=4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# =====================================================================================
# wrappers and dispatch on the CPU
# =====================================================================================
def test_cpu_wrappers_return_the_plain_versions():
    arrays = _decode_inputs(*DECODE_CASES[0])
    before = kernels.launch_counts()
    np.testing.assert_array_equal(
        tpa.paged_flash_decode(*_t(*arrays)).numpy(),
        tpa.paged_decode_attention_torch(*_t(*arrays)).numpy(),
    )
    chunk = _chunk_inputs(*CHUNK_CASES[0])
    np.testing.assert_array_equal(
        tpa.paged_flash_prefill_chunk(*_t(*chunk)).numpy(),
        tpa.paged_prefill_chunk_torch(*_t(*chunk)).numpy(),
    )
    assert kernels.launch_counts() == before  # no kernel launched on the CPU


@pytest.mark.parametrize("impl", ["auto", "torch"])
def test_ops_dispatch_on_cpu(impl):
    arrays = _t(*_decode_inputs(*DECODE_CASES[1]))
    got = ops.paged_decode_attention(*arrays, block_pages=1, impl=impl)
    np.testing.assert_array_equal(got.numpy(), tpa.paged_decode_attention_torch(*arrays).numpy())
    chunk = _t(*_chunk_inputs(*CHUNK_CASES[2]))
    got = ops.paged_prefill_chunk_attention(*chunk, impl=impl)
    np.testing.assert_array_equal(got.numpy(), tpa.paged_prefill_chunk_torch(*chunk).numpy())


def test_impl_cuda_on_cpu_tensors_raises():
    arrays = _t(*_decode_inputs(*DECODE_CASES[0]))
    with pytest.raises(ValueError, match="CUDA"):
        ops.paged_decode_attention(*arrays, impl="cuda")
    with pytest.raises(ValueError, match="impl"):
        ops.paged_decode_attention(*arrays, impl="pallas")


def test_block_pages_must_divide_the_table():
    arrays = _t(*_decode_inputs(*DECODE_CASES[0]))  # max_pages 3
    with pytest.raises(ValueError, match="divide"):
        tpa.paged_flash_decode(*arrays, block_pages=2)


@pytest.mark.parametrize("bp,max_pages", [(None, 8), (0, 8), (3, 8), (4, 8), (16, 8), (5, 7)])
def test_effective_block_pages_matches_reference(bp, max_pages):
    assert ops.effective_block_pages(bp, max_pages) == jops.effective_block_pages(bp, max_pages)


def test_kernel_source_exports_the_wrapped_entries():
    src = (tpa.__file__.rsplit("/", 1)[0] + "/csrc/paged_attention.cu")
    text = open(src).read()
    for name in ("repro_paged_decode", "repro_paged_prefill_chunk", "repro_cuda_error_string"):
        assert f"{name}(" in text


# =====================================================================================
# sample_tokens
# =====================================================================================
def _sample(x, vocab=32, temperature=0.0, top_k=0, top_p=1.0, seed=0, pos=0):
    b = x.shape[0]
    return ops.sample_tokens(
        torch.as_tensor(x), torch.full((b,), temperature), torch.full((b,), top_k),
        torch.full((b,), top_p), torch.full((b,), seed), torch.full((b,), pos), vocab=vocab,
    ).numpy()


def test_sample_greedy_matches_host_argmax_and_reference():
    x = np.random.default_rng(0).standard_normal((3, 40)).astype(np.float32)
    got = _sample(x)
    np.testing.assert_array_equal(got, np.argmax(x[:, :32], axis=-1))
    b = 3
    want = jops.sample_tokens(
        jnp.asarray(x), jnp.zeros((b,), jnp.float32), jnp.zeros((b,), jnp.int32),
        jnp.ones((b,), jnp.float32), jnp.zeros((b,), jnp.uint32), jnp.zeros((b,), jnp.int32),
        vocab=32,
    )
    np.testing.assert_array_equal(got, np.asarray(want))


def test_sample_greedy_ignores_vocab_pad():
    x = np.full((2, 8), -5.0, np.float32)
    x[:, 6:] = 100.0
    assert (_sample(x, vocab=6) < 6).all()
    assert (_sample(x, vocab=6, temperature=1.0) < 6).all()


def test_sample_top_k_restricts_support():
    x = np.random.default_rng(1).standard_normal((3, 40)).astype(np.float32)
    top3 = np.argsort(x[:, :32], axis=-1)[:, -3:]
    for seed in range(12):
        got = _sample(x, temperature=5.0, top_k=3, seed=seed)
        assert all(got[i] in top3[i] for i in range(3))


def test_sample_tiny_top_p_is_argmax():
    x = np.random.default_rng(2).standard_normal((3, 40)).astype(np.float32)
    np.testing.assert_array_equal(
        _sample(x, temperature=1.0, top_p=1e-6, seed=3), np.argmax(x[:, :32], axis=-1)
    )


def test_sample_is_a_function_of_seed_and_position_only():
    x = np.random.default_rng(3).standard_normal((4, 64)).astype(np.float32)
    a = _sample(x, vocab=64, temperature=1.0, seed=7, pos=5)
    np.testing.assert_array_equal(a, _sample(x, vocab=64, temperature=1.0, seed=7, pos=5))
    # a row's draw does not depend on the rest of the batch
    np.testing.assert_array_equal(a[2:], _sample(x[2:], vocab=64, temperature=1.0, seed=7, pos=5))
    draws = {tuple(_sample(x, vocab=64, temperature=2.0, seed=s, pos=p)) for s in range(4)
             for p in range(4)}
    assert len(draws) > 4  # seeds and positions select different streams


def test_sample_mixed_greedy_and_sampled_rows():
    x = np.random.default_rng(4).standard_normal((2, 40)).astype(np.float32)
    temp = torch.tensor([0.0, 1.5])
    got = ops.sample_tokens(
        torch.as_tensor(x), temp, torch.zeros(2, dtype=torch.int32), torch.ones(2),
        torch.tensor([9, 9]), torch.tensor([3, 3]), vocab=32,
    ).numpy()
    assert got[0] == np.argmax(x[0, :32])


@pytest.mark.parametrize("width", [128, 151936])
@pytest.mark.parametrize("seed", [0, 1, 2**31 + 5, 2**32 - 1])
def test_gumbel_noise_is_bit_equal_to_jax_random(seed, width):
    """The reference draws jax.random.gumbel(fold_in(PRNGKey(seed), pos),
    (Vp,)) per row; the port's noise must be the same f32 bits."""
    pos = [0, 1, 4095]
    got = ops.gumbel_noise(torch.full((3,), seed, dtype=torch.int64), torch.tensor(pos),
                           width).numpy()
    for row, p in enumerate(pos):
        key = jax.random.fold_in(jax.random.PRNGKey(np.uint32(seed)), np.int32(p))
        want = np.asarray(jax.random.gumbel(key, (width,), jnp.float32))
        np.testing.assert_array_equal(got[row].view(np.uint32), want.view(np.uint32))


def test_gumbel_noise_is_standard_gumbel():
    g = ops.gumbel_noise(torch.arange(64), torch.arange(64) * 3, 4096).numpy()
    assert abs(g.mean() - 0.5772) < 0.01 and abs(g.std() - np.pi / np.sqrt(6)) < 0.01
