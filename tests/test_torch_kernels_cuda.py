"""repro_torch's CUDA kernels against their plain PyTorch versions, on the card:
paged decode and chunked prefill over f32/bf16 and int8/int4 pools, the
quantized matmul, and the paper-suite kernels (sum3d, stencil3d, tinymatsum
static and dynamic, matvec right and left) with the ops dispatchers on
MdSpans.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: the
kernels have no CPU mode (the plain versions they are held against are what
the CPU tests check against the JAX reference). This file imports no JAX, so
it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: f32 rtol/atol 2e-5 (the reference's kernel-vs-oracle bound);
bf16 pools within one bf16 ulp of the plain output plus the f32 tolerance
2e-5 (both sum in f32 and round once; near 0 the bf16 spacing is finer than
f32 sums resolve). Paper suite: sum3d within 1e-5 * sum(|x|) (another
summation order) and bit-identical from run to run; stencil3d and
tinymatsum exactly equal (the same f32 additions in the same order);
matvec rtol/atol 2e-4 (the reference's), bf16 one ulp + 2e-4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import (
    Extents, LayoutLeft, LayoutRight, MdSpan, QuantizedAccessor, quantize_array,
)
from repro_torch.kernels import matvec as tmv
from repro_torch.kernels import ops
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import quant_matmul as qmm
from repro_torch.kernels import stencil3d as tst
from repro_torch.kernels import sum3d as tsum
from repro_torch.kernels import tinymatsum as ttiny

pytestmark = pytest.mark.cuda

TOL = dict(rtol=2e-5, atol=2e-5)

# (batch, page_size, lens, hq, hkv, d)
DECODE_CASES = [
    (2, 8, (5, 20), 4, 2, 16),
    (3, 16, (1, 16, 31), 4, 2, 16),
    (1, 4, (13,), 4, 2, 32),
    (4, 16, (0, 16, 33, 70), 14, 2, 64),
    (8, 16, (0, 1, 16, 100, 517, 1024, 1500, 2048), 14, 2, 64),
    (2, 16, (40, 300), 16, 2, 128),
    (2, 64, (40, 300), 8, 2, 64),
]

# (batch, hq, hkv, d, ps, C, max_pages, cursors)
CHUNK_CASES = [
    (2, 4, 2, 16, 4, 8, 6, (4, 8)),
    (2, 14, 2, 64, 16, 16, 4, (0, 32)),
    (2, 14, 2, 16, 4, 5, 5, (3, 8)),
    (3, 14, 2, 64, 16, 256, 40, (0, 128, 384)),
    (2, 16, 2, 128, 16, 40, 8, (0, 64)),
]


@pytest.fixture(autouse=True)
def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _decode_inputs(batch, page_size, lens, hq, hkv, d, dtype=torch.float32):
    max_pages = max(1, -(-max(lens) // page_size))
    num_pages = batch * max_pages + 1
    rng = np.random.default_rng(batch * 100 + page_size)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(batch, max_pages).astype(np.int32)
    return (f(batch, hq, 1, d), f(num_pages, hkv, page_size, d), f(num_pages, hkv, page_size, d),
            torch.from_numpy(bt).cuda(), torch.tensor(lens, dtype=torch.int32, device="cuda"))


def _chunk_inputs(batch, hq, hkv, d, ps, c, max_pages, cursors, dtype=torch.float32):
    num_pages = batch * max_pages + 1
    rng = np.random.default_rng(c)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
    bt = rng.permutation(np.arange(1, num_pages)).reshape(batch, max_pages).astype(np.int32)
    return (f(batch, hq, c, d), f(batch, hkv, c, d), f(batch, hkv, c, d),
            f(num_pages, hkv, ps, d), f(num_pages, hkv, ps, d), torch.from_numpy(bt).cuda(),
            torch.tensor(cursors, dtype=torch.int32, device="cuda"))


def _within_one_bf16_ulp(got, want, atol=TOL["atol"]):
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    return bool(((got.float() - w).abs() <= ulp + atol).all())


def _ids(cases):
    return [f"case{i}" for i in range(len(cases))]


@pytest.mark.parametrize("case", DECODE_CASES, ids=_ids(DECODE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_kernel_matches_plain(case, dtype):
    args = _decode_inputs(*case, dtype=dtype)
    n = pa.paged_flash_decode.launches
    got = pa.paged_flash_decode(*args)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode.launches == n + 1 and got.dtype == dtype
    want = pa.paged_decode_attention_torch(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)
    lens = case[2]
    for b, L in enumerate(lens):
        if L == 0:
            assert torch.count_nonzero(got[b]) == 0


@pytest.mark.parametrize("case", CHUNK_CASES, ids=_ids(CHUNK_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chunk_kernel_matches_plain(case, dtype):
    args = _chunk_inputs(*case, dtype=dtype)
    n = pa.paged_flash_prefill_chunk.launches
    got = pa.paged_flash_prefill_chunk(*args)
    torch.cuda.synchronize()
    assert pa.paged_flash_prefill_chunk.launches == n + 1
    want = pa.paged_prefill_chunk_torch(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)


def test_block_pages_does_not_change_the_result():
    args = _decode_inputs(*DECODE_CASES[4])  # max_pages 128
    a = pa.paged_flash_decode(*args, block_pages=1)
    b = pa.paged_flash_decode(*args, block_pages=8)
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    q, kp, vp, bt, lens = _decode_inputs(*DECODE_CASES[0])
    with pytest.raises(TypeError):
        pa.paged_flash_decode(q, kp, vp, bt.long(), lens)
    with pytest.raises(TypeError):
        pa.paged_flash_decode(q, kp.to(torch.bfloat16), vp, bt, lens)
    with pytest.raises(ValueError, match="contiguous"):
        pa.paged_flash_decode(q.transpose(1, 3).contiguous().transpose(1, 3), kp, vp, bt, lens)
    with pytest.raises(ValueError, match="head dim"):
        pa.paged_flash_decode(q[..., :8].contiguous(), kp[..., :8].contiguous(),
                              vp[..., :8].contiguous(), bt, lens)
    with pytest.raises(ValueError, match="CUDA"):
        pa.paged_flash_decode(q, kp, vp, bt.cpu(), lens)


# (batch, page_size, lens, hq, hkv, d) x bits, and (hq, hkv, d, ps, C,
# max_pages, cursors) x bits, over intN pools
QUANT_DECODE_CASES = [DECODE_CASES[i] for i in (0, 2, 3, 4, 5)]
QUANT_CHUNK_CASES = [CHUNK_CASES[i] for i in (0, 2, 3, 4)]
# (M, N, K, qblock): the serve shapes (decode rows, one 128-token chunk; the
# MLP's 896 x 4864 and 4864 x 896) and ragged edges
QMM_CASES = [(8, 4864, 896, 128), (128, 896, 4864, 128), (1, 70, 192, 64), (33, 130, 256, 32)]


def _quantize_pool(pool, bits):
    """An f32 pool encoded as the engine encodes pages (PagedQuantSpec)."""
    from repro_torch.serving.engine import KV_DTYPES

    enc = KV_DTYPES[f"int{bits}"].encode_pages(pool.float())
    return enc["q"].contiguous(), enc["scale"].contiguous()


@pytest.mark.parametrize("case", QUANT_DECODE_CASES, ids=_ids(QUANT_DECODE_CASES))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_decode_quant_kernel_matches_plain(case, bits, dtype):
    q, kp, vp, bt, lens = _decode_inputs(*case, dtype=dtype)
    args = (q, *_quantize_pool(kp, bits), *_quantize_pool(vp, bits), bt, lens)
    n = pa.paged_flash_decode_quant.launches
    got = pa.paged_flash_decode_quant(*args, bits=bits)
    torch.cuda.synchronize()
    assert pa.paged_flash_decode_quant.launches == n + 1 and got.dtype == dtype
    want = pa.paged_decode_attention_quant_torch(*args, bits=bits)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("case", QUANT_CHUNK_CASES, ids=_ids(QUANT_CHUNK_CASES))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chunk_quant_kernel_matches_plain(case, bits, dtype):
    q, ck, cv, kp, vp, bt, cur = _chunk_inputs(*case, dtype=dtype)
    args = (q, ck, cv, *_quantize_pool(kp, bits), *_quantize_pool(vp, bits), bt, cur)
    n = pa.paged_flash_prefill_chunk_quant.launches
    got = pa.paged_flash_prefill_chunk_quant(*args, bits=bits)
    torch.cuda.synchronize()
    assert pa.paged_flash_prefill_chunk_quant.launches == n + 1
    want = pa.paged_prefill_chunk_quant_torch(*args, bits=bits)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("case", QMM_CASES, ids=_ids(QMM_CASES))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_matmul_kernel_matches_plain(case, bits, dtype):
    m, n, k, qblock = case
    g = torch.Generator(device="cuda").manual_seed(m + n)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    w = torch.randn(n, k, generator=g, device="cuda") / k ** 0.5
    bufs = quantize_array(w, QuantizedAccessor(torch.float32, bits=bits, block=qblock))
    launches = qmm.quant_matmul.launches
    got = qmm.quant_matmul(x, bufs["q"], bufs["scale"], bits=bits)
    torch.cuda.synchronize()
    assert qmm.quant_matmul.launches == launches + 1 and got.dtype == dtype
    want = qmm.quant_matmul_torch(x, bufs["q"], bufs["scale"], bits=bits)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)


def _engines_agree(kv_dtype: str, quantized: bool, need):
    """The smoke model's engine on the card (kernels) gives the CPU engine's
    (plain versions) greedy tokens, and every kernel in ``need`` ran."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    cpu = build_model(cfg, quantized=quantized, device="cpu")
    params_cpu = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, quantized=quantized, device="cuda")

    def to_cuda(tree):
        if isinstance(tree, dict):
            return {k: to_cuda(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [to_cuda(v) for v in tree]
        return tree.cuda()

    params_gpu = to_cuda(params_cpu)
    rng = np.random.default_rng(0)
    prefix = rng.integers(0, cfg.vocab, size=10).tolist()
    prompts = [rng.integers(0, cfg.vocab, size=L).tolist() for L in (5, 9, 16, 3, 12)]
    prompts += [list(prefix), list(prefix)]
    for chunked in (False, True):
        kw = dict(num_pages=24, page_size=4, max_batch=4, max_pages_per_seq=8,
                  kv_dtype=kv_dtype, chunked_prefill=chunked, chunk_tokens=8 if chunked else 0)
        mk = lambda: [Request(i, p, GenerationParams(max_new_tokens=6))
                      for i, p in enumerate(prompts)]
        kernels.reset_launch_counts()
        res_gpu = ServeEngine(gpu, params_gpu, EngineConfig(**kw), device="cuda").run(mk())
        counts = kernels.launch_counts()
        res_cpu = ServeEngine(cpu, params_cpu, EngineConfig(**kw), device="cpu").run(mk())
        want = [k for k in need if chunked or "chunk" not in k]
        assert all(counts[k] > 0 for k in want), counts
        for i in range(len(prompts)):
            assert res_gpu[i].generated == res_cpu[i].generated, (chunked, i)


def test_engine_on_cuda_matches_engine_on_cpu():
    _engines_agree("f32", False, ["paged_decode", "paged_prefill_chunk"])


@pytest.mark.parametrize("kv_dtype", ["int8", "int4"])
def test_quantized_engine_on_cuda_matches_engine_on_cpu(kv_dtype):
    _engines_agree(kv_dtype, True,
                   ["paged_decode_quant", "paged_prefill_chunk_quant", "quant_matmul"])


# ---------------------------------------------------------------------------------
# the paper-suite kernels
# ---------------------------------------------------------------------------------
DTYPES = [torch.float32, torch.bfloat16]
DT_IDS = ["f32", "bf16"]


def _randn(shape, dtype, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(*shape, generator=g, device="cuda").to(dtype)


# one element, small, a partial last block, the reference's size, and one
# whose first pass runs the full 1024-block grid with a ragged tail
SUM3D_SHAPES = [(1, 1, 1), (4, 4, 8), (5, 7, 130), (96, 96, 96), (3, 1000, 1001)]


@pytest.mark.parametrize("shape", SUM3D_SHAPES, ids=_ids(SUM3D_SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_sum3d_kernel_matches_plain_and_repeats_bit_for_bit(shape, dtype):
    x = _randn(shape, dtype, sum(shape))
    n = tsum.sum3d.launches
    got = tsum.sum3d(x)
    torch.cuda.synchronize()
    assert tsum.sum3d.launches == n + 1 and got.dtype == torch.float32 and got.shape == ()
    want = tsum.sum3d_torch(x)
    assert abs(float(got) - float(want)) <= 1e-5 * float(x.float().abs().sum()) + 1e-6
    assert torch.equal(tsum.sum3d(x), got)


STENCIL_SHAPES = [(1, 4, 4), (2, 5, 5), (3, 3, 3), (4, 4, 4), (6, 8, 16), (12, 10, 132),
                  (5, 33, 65), (7, 2, 9)]


@pytest.mark.parametrize("shape", STENCIL_SHAPES, ids=_ids(STENCIL_SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_stencil3d_kernel_matches_plain(shape, dtype):
    x = _randn(shape, dtype, 3)
    n = tst.stencil3d.launches
    got = tst.stencil3d(x)
    torch.cuda.synchronize()
    assert tst.stencil3d.launches == n + 1 and got.dtype == dtype
    assert torch.equal(got, tst.stencil3d_torch(x))
    if min(shape) < 3:
        assert not got.any()


TINY_CASES = [(1, 1, 1), (10, 3, 3), (513, 5, 7), (70001, 8, 8), (257, 1, 8), (100, 8, 1)]


@pytest.mark.parametrize("case", TINY_CASES, ids=_ids(TINY_CASES))
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_tinymatsum_kernels_match_plain(case, static, dtype):
    o, s = _randn(case, dtype, 4), _randn(case, dtype, 5)
    fn = ttiny.tinymatsum_static if static else ttiny.tinymatsum_dynamic
    n = fn.launches
    got = fn(o, s)
    torch.cuda.synchronize()
    assert fn.launches == n + 1 and got.dtype == dtype
    assert torch.equal(got, ttiny.tinymatsum_torch(o, s))


def test_tinymatsum_static_refuses_uninstantiated_extents():
    o = _randn((4, 9, 3), torch.float32, 6)
    with pytest.raises(ValueError, match="instantiated"):
        ttiny.tinymatsum_static(o, o)
    torch.testing.assert_close(ttiny.tinymatsum_dynamic(o, o, jmax=9), o + o)


MATVEC_SHAPES = [(1, 1), (3, 5), (8, 128), (200, 384), (257, 1000)]


@pytest.mark.parametrize("shape", MATVEC_SHAPES, ids=_ids(MATVEC_SHAPES))
@pytest.mark.parametrize("layout", ["right", "left"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_matvec_kernels_match_plain(shape, layout, dtype):
    a, x = _randn(shape, dtype, 7), _randn(shape[1:], dtype, 8)
    fn = tmv.matvec_right if layout == "right" else tmv.matvec_left
    buf = a if layout == "right" else a.t().contiguous()
    n = fn.launches
    got = fn(buf, x)
    torch.cuda.synchronize()
    assert fn.launches == n + 1 and got.dtype == dtype and got.shape == shape[:1]
    want = tmv.matvec_torch(a, x)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert _within_one_bf16_ulp(got, want, atol=2e-4)


def test_paper_wrappers_refuse_what_the_kernels_do_not_take():
    a = _randn((8, 16), torch.float32, 9)
    with pytest.raises(ValueError, match="contiguous"):
        tmv.matvec_left(a.t(), _randn((16,), torch.float32, 1))
    with pytest.raises(TypeError, match="dtype"):
        tmv.matvec_right(a, _randn((16,), torch.bfloat16, 1))
    with pytest.raises(ValueError, match="shapes"):
        tmv.matvec_right(a, _randn((8,), torch.float32, 1))
    with pytest.raises(TypeError):
        tsum.sum3d(a.to(torch.float16).reshape(2, 4, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ttiny.tinymatsum_static(_randn((2, 3, 3), torch.float32, 1), torch.zeros(2, 3, 3))


@pytest.mark.parametrize("order", ["right", "left"])
def test_ops_dispatch_on_the_layout_launches_the_kernels(order):
    lay = LayoutRight if order == "right" else LayoutLeft
    x3 = _randn((6, 10, 132), torch.float32, 10)
    a, v = _randn((200, 384), torch.float32, 11), _randn((384,), torch.float32, 12)
    s3 = MdSpan.from_dense(x3, layout=lay(Extents.fully_dynamic(6, 10, 132)))
    sa = MdSpan.from_dense(a, layout=lay(Extents.fully_dynamic(200, 384)))
    mv = "matvec_right" if order == "right" else "matvec_left"
    for impl in ("auto", "cuda"):
        kernels.reset_launch_counts()
        got_sum, got_mv = ops.sum3d(s3, impl=impl), ops.matvec(sa, v, impl=impl)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["sum3d"] == 1 and counts[mv] == 1, counts
        assert abs(float(got_sum) - float(x3.sum())) <= 1e-5 * float(x3.abs().sum())
        torch.testing.assert_close(got_mv, tmv.matvec_torch(a, v), rtol=2e-4, atol=2e-4)
    kernels.reset_launch_counts()
    ops.sum3d(s3, impl="torch")
    ops.matvec(sa, v, impl="torch")
    assert not any(kernels.launch_counts().values())


def test_ops_on_plain_cuda_tensors_launch_the_kernels():
    """A plain CUDA tensor is read as LayoutRight storage: under "auto" and
    "cuda" the kernel runs on it, never the plain version; a strided one is
    refused, not copied."""
    x3 = _randn((5, 9, 131), torch.float32, 13)
    a, v = _randn((70, 129), torch.float32, 14), _randn((129,), torch.float32, 15)
    for impl in ("auto", "cuda"):
        kernels.reset_launch_counts()
        got_sum, got_mv = ops.sum3d(x3, impl=impl), ops.matvec(a, v, impl=impl)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert counts["sum3d"] == 1 and counts["matvec_right"] == 1, counts
        assert abs(float(got_sum) - float(x3.sum())) <= 1e-5 * float(x3.abs().sum())
        torch.testing.assert_close(got_mv, tmv.matvec_torch(a, v), rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="contiguous"):
        ops.sum3d(x3.transpose(0, 2), impl="cuda")
    with pytest.raises(ValueError, match="contiguous"):
        ops.matvec(a.t().contiguous().t(), v, impl="cuda")
