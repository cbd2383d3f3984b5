"""The port's differentiable attention (kernels/flash_vjp.py) against the
reference's ``flash_attention_jnp`` custom_vjp: the same numpy inputs through
both, out and the gradients of q, k, v held at 1e-5 (f32)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_vjp import flash_attention_jnp  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels.flash_vjp import (  # noqa: E402
    flash_attention_bwd,
    flash_attention_torch,
    flash_bwd_torch,
    grid_blocks,
    tiles,
)
from repro_torch.kernels.flash_attention import attention_torch  # noqa: E402

TOL = 1e-5

# (b, hq, hkv, tq, tk, d, causal, window, q_offset, block_k)
CASES = {
    "causal": (2, 4, 4, 24, 24, 16, True, None, 0, 512),
    "causal_gqa_blocks": (1, 6, 2, 40, 40, 16, True, None, 0, 16),
    "noncausal": (2, 4, 2, 20, 20, 32, False, None, 0, 512),
    "window": (1, 4, 2, 48, 48, 16, True, 8, 0, 16),
    "window_gqa4": (2, 8, 2, 33, 33, 16, True, 5, 0, 512),
    "q_offset": (1, 4, 2, 12, 44, 16, True, None, 32, 16),
    "q_offset_window": (2, 4, 1, 10, 40, 16, True, 12, 30, 16),
    "cross_tail": (2, 4, 4, 14, 37, 16, False, None, 0, 16),
    "cross_tail_gqa": (1, 6, 3, 9, 70, 32, False, None, 0, 32),
}


def _inputs(b, hq, hkv, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hq, tq, d), dtype=np.float32)
    k = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    v = rng.standard_normal((b, hkv, tk, d), dtype=np.float32)
    g = rng.standard_normal((b, hq, tq, d), dtype=np.float32)
    return q, k, v, g


def _reference(q, k, v, g, causal, window, q_offset, block_k):
    def f(q_, k_, v_):
        return flash_attention_jnp(q_, k_, v_, jnp.asarray(q_offset, jnp.int32), causal,
                                   window, None, block_k)

    out, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in (out, *vjp(jnp.asarray(g)))]


@pytest.mark.parametrize("case", sorted(CASES))
def test_flash_attention_torch_matches_reference_vjp(case):
    b, hq, hkv, tq, tk, d, causal, window, off, block_k = CASES[case]
    q, k, v, g = _inputs(b, hq, hkv, tq, tk, d, seed=sorted(CASES).index(case))
    want = _reference(q, k, v, g, causal, window, off, block_k)
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = flash_attention_torch(qt, kt, vt, causal=causal, window=window, q_offset=off,
                                block_k=block_k)
    out.backward(torch.from_numpy(g))
    for name, got, ref in zip(("out", "dq", "dk", "dv"), (out, qt.grad, kt.grad, vt.grad),
                              want):
        np.testing.assert_allclose(got.detach().numpy(), ref, rtol=TOL, atol=TOL, err_msg=name)


@pytest.mark.parametrize("case", ["q_offset", "window"])
def test_tensor_q_offset_gives_the_same_gradients(case):
    b, hq, hkv, tq, tk, d, causal, window, off, block_k = CASES[case]
    q, k, v, g = _inputs(b, hq, hkv, tq, tk, d, seed=3)
    grads = []
    for offset in (off, torch.tensor(off, dtype=torch.int32)):
        qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
        flash_attention_torch(qt, kt, vt, causal=causal, window=window, q_offset=offset,
                              block_k=block_k).backward(torch.from_numpy(g))
        grads.append((qt.grad, kt.grad, vt.grad))
    for a, b_ in zip(*grads):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_block_size_does_not_change_the_result():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 30, 30, 16, seed=5))
    out, lse = attention_torch(q, k, v, causal=True, return_lse=True)
    ref = flash_bwd_torch(q, k, v, out, g, lse, block_k=512)
    for bk in (7, 16):
        for a, b_ in zip(flash_bwd_torch(q, k, v, out, g, lse, block_k=bk), ref):
            torch.testing.assert_close(a, b_, rtol=1e-5, atol=1e-6)


def test_lse_is_the_log_sum_exp_of_the_live_scores():
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(2, 4, 2, 12, 20, 16, seed=7))
    _, lse = attention_torch(q, k, v, causal=True, window=6, q_offset=8, return_lse=True,
                             block_k=8)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k.repeat_interleave(2, dim=1)) / 4.0
    qp = torch.arange(12)[:, None] + 8
    kp = torch.arange(20)[None, :]
    live = (kp <= qp) & (kp > qp - 6)
    want = torch.logsumexp(s.masked_fill(~live, float("-inf")), dim=-1)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)


def test_fully_masked_row_has_zero_gradients():
    """A query row with no live key (q_offset past a window of keys that all
    lie behind it): output 0, lse NEG_INF, and zero dq, not NaN."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 2, 2, 4, 4, 16, seed=9))
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out = flash_attention_torch(qt, kt, vt, causal=True, window=2, q_offset=10)
    out.backward(g)
    assert torch.all(out == 0)
    for t in (qt.grad, kt.grad, vt.grad):
        assert torch.isfinite(t).all() and torch.all(t == 0)


def test_ops_attention_is_differentiable_only_under_grad():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 16, 16, 16, seed=11))
    with torch.no_grad():
        plain = ops.attention(q, k, v)
    assert plain.grad_fn is None
    qt, kt, vt = (x.clone().requires_grad_() for x in (q, k, v))
    out = ops.attention(qt, kt, vt)
    assert out.grad_fn is not None
    torch.testing.assert_close(out.detach(), plain, rtol=0, atol=0)
    out.backward(g)
    assert all(t.grad is not None for t in (qt, kt, vt))


def test_bwd_wrapper_on_cpu_is_the_plain_backward():
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 4, 2, 16, 24, 16, seed=13))
    out, lse = attention_torch(q, k, v, causal=False, return_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, out, g, lse, causal=False)
    assert flash_attention_bwd.launches == before
    for a, b_ in zip(got, flash_bwd_torch(q, k, v, out, g, lse, causal=False)):
        torch.testing.assert_close(a, b_, rtol=0, atol=0)


def test_tiles_and_grid():
    f32, bf16 = torch.float32, torch.bfloat16
    # f32: the CUDA-core tiles, (keys, rows, rows, keys)
    assert tiles(64, f32) == (64, 64, 64, 64) and tiles(128, f32) == (64, 64, 64, 64)
    assert tiles(256, f32) == (32, 32, 32, 32)
    # bf16: 64 keys a dK/dV block, walked in tiles of 64 query rows (32 above D 64);
    # 64 rows a dQ block, walked in tiles of 64 keys (32 at D 256)
    assert tiles(64, bf16) == (64, 64, 64, 64) and tiles(112, bf16) == (64, 32, 64, 64)
    assert tiles(128, bf16) == (64, 32, 64, 64) and tiles(256, bf16) == (64, 32, 64, 32)
    # llama3.2-1b's training shape: 32 key tiles a kv head, 32 query tiles a q head
    for dt in (f32, bf16):
        assert grid_blocks(4, 32, 8, 2048, 2048, 64, dt) == (32 * 8 * 4, 32 * 32 * 4)
    assert grid_blocks(1, 8, 1, 512, 512, 256, f32) == (16, 16 * 8)
    assert grid_blocks(1, 8, 1, 512, 512, 256, bf16, splits=16) == (8 * 16, 8 * 8)
