"""repro_torch's CUDA kernels against their plain PyTorch versions, on the card:
paged decode and chunked prefill over f32/bf16 and int8/int4 pools, and the
quantized matmul.

Every test here is marked ``cuda`` and skips without an NVIDIA GPU: the
kernels have no CPU mode (the plain versions they are held against are what
the CPU tests check against the JAX reference). This file imports no JAX, so
it runs on the machine with the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Tolerances: f32 rtol/atol 2e-5 (the reference's kernel-vs-oracle bound);
bf16 pools within one bf16 ulp of the plain output plus the f32 tolerance
2e-5 (both sum in f32 and round once; near 0 the bf16 spacing is finer than
f32 sums resolve).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels
from repro_torch.core import QuantizedAccessor, quantize_array
from repro_torch.kernels import paged_attention as pa
from repro_torch.kernels import quant_matmul as qmm

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


def _within_one_bf16_ulp(got, want):
    w = want.float()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    return bool(((got.float() - w).abs() <= ulp + TOL["atol"]).all())


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
