"""repro_torch's CUDA kernels against their plain PyTorch versions, on the card:
paged decode and chunked prefill over f32/bf16 and int8/int4 pools, the
quantized matmul, the paper-suite kernels (sum3d, stencil3d, tinymatsum
static and dynamic, matvec right and left) with the ops dispatchers on
MdSpans, the dense-cache kernels (flash_attention, flash_decode,
ssd_scan) with the ops dispatchers that reach them, and recurrentgemma's
(rglru_scan; the flash kernels at head dim 256 over a windowed ring); the
split-K paged decode at lengths on, past and inside its split boundaries,
the same split-K body over the dense cache (flash_decode) at every head dim
and group, its workspace against the plain partials, the bf16 tensor-core
flash_attention body at every head dim, and matvec over ragged and
16-byte-misaligned buffers, two runs bit-identical; quant_matmul's three
schedules (stream, mma, fma) at M 1-130, N 896 / 4864 / 130, K of one
block and split unevenly, int8 and int4, over a q one byte off 16 too, and
the bf16 tensor-core chunk body over dense, int8 and int4 pools at every
head dim (cursor 0, one page, tiles across pages of different scales, C 5,
128, 256), over pools off 16 bytes, against its tiled twin, two runs
bit-identical; rglru_scan at its ring's stage edges, off 16 bytes and on
grids that walk many work items (chained halves and every form bit-equal),
and stencil3d's staged planes at 512^3, any run length, K off 16 bytes and
the grid's reach; the chunk kernels at the speculative verify's shape (B 8,
C 2 and 5, cursors mid-page and page-aligned), the fused K-step and the
speculative S-window dispatches under set_sync_debug_mode("error") (no
device-to-host transfer inside), and the speculative and fused engines on
the card against the plain engine on the CPU; the paged decode over block
tables as best-of-n forks and beam reorders leave them (rows aliasing one
row's pages, rows repeating other rows' tables), a grammar K-step window and
a sampled step over forked rows under the sync debug mode, int4 pages
demoted to the host tier and promoted back byte for byte, and the best-of-n,
beam, grammar and tiered engines on the card against the same engines on
the CPU; the paged decode and chunk kernels at head dim 128 and the dense
configs' groups 4 and 8, page sizes 8 and 32, over dense, int8 and int4
pages, and the autotuner's cold sweep (block_pages 1 only on the card) and
warm resolve (no launch); and head dim 112 (kimi-k2: Hq 64, Hkv 8): the
paged decode and chunk (C 128, the verify C 5) over dense, int8 and int4
pages (56-byte int4 rows), the chunk body over pools off 16 bytes, and
flash_attention / flash_decode, f32 and bf16; and the cross-attention
shapes (whisper-large-v3's 1500 frames, llama-3.2-vision's 6404 image
tokens): flash_attention non-causal at Tq != Tk over key tails, flash_decode
at pos Tc - 1, and whisper-smoke / vision-smoke served on the card against
the CPU.

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
matvec rtol/atol 2e-4 (the reference's), bf16 one ulp + 2e-4. SSD scan:
rtol/atol 1e-4 in f32 (the kernel's 64-step chunks sum in another order than
the plain version's), bf16 y one ulp + 1e-4. RG-LRU scan: rtol/atol 1e-5
in f32 (a sequential loop against a log-depth scan), bf16 y one ulp + 1e-5.
The ring decode is also held against the reference's ring mask (an f32
einsum over the absolute positions) with the attention tolerances.
"""
import dataclasses
import math

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro_torch import kernels
from repro_torch.core import (
    Extents, LayoutLeft, LayoutRight, MdSpan, QuantizedAccessor, quantize_array,
)
from repro_torch.kernels import _build
from repro_torch.kernels import _paper_suite as paper_suite
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
    (plain versions) greedy tokens, and every kernel in ``need`` ran (the
    chunk kernels in chunked mode only; flash_attention, the monolithic
    prefill's, in monolithic mode only)."""
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
        want = [k for k in need if chunked or "chunk" not in k] + (
            [] if chunked else ["flash_attention"])
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


# one element, small, a partial last step of the walk, the reference's size
# (216 f32 / 108 bf16 blocks of a whole step each, fewer than a wave), and
# one whose grid is a few hundred blocks with its last step part-empty
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


def _sum3d_close(got, x):
    want = tsum.sum3d_torch(x)
    assert got.dtype == torch.float32 and got.shape == ()
    assert abs(float(got) - float(want)) <= 1e-5 * float(x.float().abs().sum()) + 1e-6


def _sum3d_wave(dtype):
    """The card's resident blocks of the kernel (the occupancy query x SMs)."""
    dev = torch.device("cuda")
    return paper_suite.sum3d_blocks_per_sm(paper_suite.DTYPE_CODE[dtype], dev) * pa.sm_count(dev)


# views 4 / 8 / 12 bytes off 16 (f32) and 2 / 6 / 14 (bf16): the scalar head
SUM3D_OFFSETS = [(torch.float32, 1), (torch.float32, 2), (torch.float32, 3),
                 (torch.bfloat16, 1), (torch.bfloat16, 3), (torch.bfloat16, 7)]


@pytest.mark.parametrize("dt_off", SUM3D_OFFSETS, ids=["f32+4", "f32+8", "f32+12", "bf16+2",
                                                       "bf16+6", "bf16+14"])
@pytest.mark.parametrize("shape", [(1, 1, 3), (5, 7, 130), (95, 97, 99)],
                         ids=["1x1x3", "5x7x130", "95x97x99"])
def test_sum3d_views_off_16_bytes(dt_off, shape):
    dtype, off = dt_off
    x = _offset_view(_randn(shape, dtype, 21), off)
    assert x.data_ptr() % 16 == off * x.element_size()
    got = tsum.sum3d(x)
    _sum3d_close(got, x)
    assert torch.equal(tsum.sum3d(x), got)


def _stride_sizes(dtype):
    """n of 1, 7, 8, 9, 31 and 33 elements, and n one vector either side of
    a whole grid-stride of a full wave (VECS strides, so the grid is one
    wave), and on it."""
    lanes = tsum.VEC_BYTES // torch.tensor([], dtype=dtype).element_size()
    stride = _sum3d_wave(dtype) * tsum.THREADS * lanes
    return [1, 7, 8, 9, 31, 33] + [tsum.VECS * stride + d for d in (-lanes, 0, lanes)]


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_sum3d_small_sizes_and_stride_edges(dtype):
    for n in _stride_sizes(dtype):
        x = _randn((1, 1, n), dtype, n % 1000)
        _sum3d_close(tsum.sum3d(x), x)
    full = tsum.grid_for(torch.empty(1, 1, _stride_sizes(dtype)[-2], dtype=dtype, device="cuda"))
    assert full == _sum3d_wave(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_sum3d_is_exact_on_integers_at_every_offset(dtype):
    """Integers in [-3, 3], n <= 2^21: every partial sum is an integer below
    2^24, exact in f32 in any order, so the kernel equals the exact total bit
    for bit at every alignment: head, vectors and tail add each element once."""
    esz = torch.tensor([], dtype=dtype).element_size()
    lanes = tsum.VEC_BYTES // esz
    walk = 2_048_000  # whole steps of its grid: 500 (f32) / 250 (bf16) blocks
    g = torch.Generator(device="cuda").manual_seed(22)
    for n in [1, 7, 9, 33, 1000, 3 * 2 ** 19 + 5, 2 ** 21, walk - lanes, walk, walk + lanes]:
        vals = torch.randint(-3, 4, (n,), generator=g, device="cuda").to(dtype)
        exact = float(vals.double().sum())
        for off in range(16 // esz):
            x = _offset_view(vals.view(1, 1, n), off)
            assert float(tsum.sum3d(x)) == exact, (n, off)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_sum3d_launches_one_kernel_a_call(dtype):
    """One CUDA kernel a call, the partials folded in it (the profiler's
    count, after a first call has loaded the library)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    x = _randn((96, 96, 96), dtype, 23)
    tsum.sum3d(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        got = tsum.sum3d(x)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events() if e.device_type == DeviceType.CUDA]
    assert len(names) == 1 and "sum3d_kernel" in names[0], names
    _sum3d_close(got, x)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_sum3d_grid_is_at_most_one_wave(dtype):
    """The occupancy query answers, and the wrapper's grid is at most the
    card's resident blocks: all of them at 512^3, fewer at 96^3 where the
    buffer does not give each a whole step."""
    wave = _sum3d_wave(dtype)
    assert wave >= pa.sm_count(torch.device("cuda"))
    assert tsum.grid_for(torch.empty(512, 512, 512, dtype=dtype, device="cuda")) == wave
    assert 1 <= tsum.grid_for(torch.empty(96, 96, 96, dtype=dtype, device="cuda")) < wave


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_sum3d_two_runs_bit_equal_at_512(dtype):
    x = (_randn((512, 512, 512), torch.float32, 24) + 1.0).to(dtype)
    first = tsum.sum3d(x)
    _sum3d_close(first, x)
    assert torch.equal(tsum.sum3d(x), first)


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


# The redesigned kernel's edges: the paper's HBM size; I no multiple of the
# planned run (150 = 4 x 32 + 22); J and K no multiples of the 8 x 64 tile,
# K off 16 bytes (65, 131: the plain-load staging) and on them (68, 72)
STENCIL_EDGE_SHAPES = [(512, 512, 512), (150, 512, 512), (9, 37, 65), (6, 19, 131),
                       (11, 45, 68), (5, 50, 72), (70, 3, 33)]


@pytest.mark.parametrize("shape", STENCIL_EDGE_SHAPES, ids=_ids(STENCIL_EDGE_SHAPES))
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_stencil3d_edges_are_equal_to_plain(shape, dtype):
    x = _randn(shape, dtype, 5)
    plan = tst.plan_for(x)
    n = tst.stencil3d.launches
    got = tst.stencil3d(x)
    torch.cuda.synchronize()
    assert tst.stencil3d.launches == n + 1
    assert torch.equal(got, tst.stencil3d_torch(x))
    if shape == (150, 512, 512):
        assert plan.run == tst.MAX_RUN and 150 % plan.run != 0


def _stencil_raw(x, run):
    """The kernel through its C entry with an explicit run length."""
    out = torch.empty_like(x)
    i, j, k = x.shape
    paper_suite.launch("repro_stencil3d", "stencil3d", paper_suite.DTYPE_CODE[x.dtype],
                       x.data_ptr(), out.data_ptr(), i, j, k, run, device=x.device)
    return out


@pytest.mark.parametrize("run", [1, 2, 7, tst.MAX_RUN])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_stencil3d_any_run_length_is_equal_to_plain(run, dtype):
    """Runs of one plane, of a few, and of the longest, over an I that none
    divides, on 16 bytes (the 16-byte copies) and on a view off them (plain
    loads): one result."""
    x = _randn((67, 40, 96), dtype, 6)
    want = tst.stencil3d_torch(x)
    v = _offset_view(x, 1)
    assert v.data_ptr() % 16 != 0
    assert torch.equal(_stencil_raw(x, run), want) and torch.equal(_stencil_raw(v, run), want)
    torch.cuda.synchronize()


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_stencil3d_off_16_bytes_and_two_runs_give_the_same_bits(dtype):
    """A view off 16 bytes stages with plain loads and gives the plain
    version's bits; two runs are bit-equal."""
    x = _randn((33, 40, 96), dtype, 7)
    v = _offset_view(x, 1)
    assert v.data_ptr() % 16 != 0
    got = tst.stencil3d(v)
    assert torch.equal(got, tst.stencil3d_torch(x)) and torch.equal(tst.stencil3d(v), got)
    assert torch.equal(tst.stencil3d(x), tst.stencil3d(x))


def test_stencil3d_grid_reach():
    """The grid's y (J / TILE_J tiles) and z (I / MAX_RUN runs) end at 65535:
    at the edge the kernel runs, past it the wrapper refuses."""
    assert tst.MAX_I == tst.MAX_RUN * 65535 and tst.MAX_J == tst.TILE_J * 65535
    for shape in ((tst.MAX_I, 1, 1), (1, tst.MAX_J, 1), (3, tst.MAX_J, 3)):
        x = torch.ones(shape, device="cuda")
        assert torch.equal(tst.stencil3d(x), tst.stencil3d_torch(x))
    for shape in ((tst.MAX_I + 1, 1, 1), (1, tst.MAX_J + 1, 1)):
        with pytest.raises(ValueError, match="grid covers"):
            tst.stencil3d(torch.ones(shape, device="cuda"))
    with pytest.raises(RuntimeError, match="launch failed"):  # the C entry's own check
        _stencil_raw(torch.ones((tst.MAX_I + 1, 1, 1), device="cuda"), tst.MAX_RUN)


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_stencil3d_plan_fills_the_card(dtype):
    """512^3: runs of MAX_RUN planes, more blocks than the card holds at once; 96^3
    (the reference's): runs shortened to the shortest whose blocks fit the
    resident slots (the library's occupancy query) at once, more blocks than
    SMs."""
    dev = torch.device("cuda")
    resident = paper_suite.stencil3d_blocks_per_sm(paper_suite.DTYPE_CODE[dtype], dev)
    slots = resident * pa.sm_count(dev)
    assert resident >= 1
    big = tst.plan_for(torch.empty(512, 512, 512, dtype=dtype, device=dev))
    assert big.run == tst.MAX_RUN and big.blocks >= slots
    small = tst.plan_for(torch.empty(96, 96, 96, dtype=dtype, device=dev))
    assert small.run < tst.MAX_RUN and pa.sm_count(dev) < small.blocks <= slots


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


EXTENTS = [(j, k) for j in range(1, 9) for k in range(1, 9)]


@pytest.mark.parametrize("jk", EXTENTS, ids=_ids(EXTENTS))
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_tinymatsum_kernels_match_plain_at_every_extent(jk, static, dtype):
    """Every instantiated (J, K): padded and unpadded stages, the vector form
    (N J K whole 16-byte chunks) and the scalar one (N 1001: ragged for most
    extents), each bit-equal to the plain version."""
    fn = ttiny.tinymatsum_static if static else ttiny.tinymatsum_dynamic
    for n in (1024, 1001):
        o, s = _randn((n, *jk), dtype, 4), _randn((n, *jk), dtype, 5)
        assert torch.equal(fn(o, s), ttiny.tinymatsum_torch(o, s))


def _tiny_plan(n, j, k, dtype, static):
    """plan_tinymatsum for aligned buffers, with the card's SM count and the
    kernel's occupancy (what the wrappers plan for aligned tensors)."""
    dev = torch.device("cuda")
    code, esz = paper_suite.DTYPE_CODE[dtype], torch.tensor([], dtype=dtype).element_size()
    return ttiny.plan_tinymatsum(
        n, j, k, esz, True, pa.sm_count(dev),
        lambda smem: paper_suite.tinymatsum_blocks_per_sm(code, static, j, k, smem, dev))


def _tiny_edges(plan):
    """N on either side of one span, of one wave of blocks, and several waves."""
    wave = plan.bn * plan.grid
    return [1, plan.bn - 1, plan.bn, plan.bn + 1, wave - 1, wave, wave + 1, 3 * wave + 5]


TINY_EDGE_SHAPES = [(3, 3), (8, 8), (5, 7)]


@pytest.mark.parametrize("jk", TINY_EDGE_SHAPES, ids=_ids(TINY_EDGE_SHAPES))
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_tinymatsum_at_span_and_wave_edges(jk, static, dtype):
    """N at the edges of the HBM-size plan's spans and waves, run with that
    plan (partial spans, blocks with no span, several spans a block) and with
    each N's own plan; both bit-equal to the plain version."""
    fn = ttiny.tinymatsum_static if static else ttiny.tinymatsum_dynamic
    esz = torch.tensor([], dtype=dtype).element_size()
    big = _tiny_plan(8_000_000, *jk, dtype, static)
    for n in _tiny_edges(big):
        o, s = _randn((n, *jk), dtype, n), _randn((n, *jk), dtype, n + 1)
        want = ttiny.tinymatsum_torch(o, s)
        plan = dataclasses.replace(big, vec=big.vec and n * jk[0] * jk[1] * esz % 16 == 0)
        assert torch.equal(fn(o, s, plan=plan), want), n
        assert torch.equal(fn(o, s), want), n


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
def test_tinymatsum_any_grid(static):
    """One block and a few, walking many spans each, in the scalar and the
    vector form."""
    fn = ttiny.tinymatsum_static if static else ttiny.tinymatsum_dynamic
    o, s = _randn((10_007, 4, 4), torch.float32, 11), _randn((10_007, 4, 4), torch.float32, 12)
    want = ttiny.tinymatsum_torch(o, s)
    base = ttiny.plan_tinymatsum(10_007, 4, 4, 4, True, 1, lambda smem: 1)
    for grid in (1, 3):
        plan = dataclasses.replace(base, grid=grid, vec=False)
        assert torch.equal(fn(o, s, plan=plan), want)
    o, s = o[:10_000], s[:10_000]
    for grid in (1, 3):
        plan = dataclasses.replace(base, grid=grid)
        assert torch.equal(fn(o, s, plan=plan), ttiny.tinymatsum_torch(o, s))


@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_tinymatsum_grid_is_the_resident_blocks(dtype):
    """The library's occupancy query answers for every instantiation at its
    plan's shared memory (the dynamic kernel past 48 KB too, after its
    opt-in), and the wrappers' plan launches no more blocks than fit on the
    card at once."""
    dev = torch.device("cuda")
    code, esz = paper_suite.DTYPE_CODE[dtype], torch.tensor([], dtype=dtype).element_size()
    sms = pa.sm_count(dev)
    for j, k in EXTENTS:
        for static in (True, False):
            plan = _tiny_plan(8_000_000, j, k, dtype, static)
            smem = ttiny.stage_bytes(j, k, esz, plan.bn)
            assert paper_suite.tinymatsum_blocks_per_sm(code, static, j, k, smem, dev) >= 1
    assert paper_suite.tinymatsum_blocks_per_sm(code, False, 100, 100, 80_032, dev) >= 1
    assert paper_suite.tinymatsum_blocks_per_sm(code, False, 200, 200, 0, dev) >= 1
    o = _randn((8_000_000, 3, 3), dtype, 18)
    out = torch.empty_like(o)
    for static in (True, False):
        plan = ttiny.plan_for(o, o, out, static)
        smem = ttiny.stage_bytes(3, 3, esz, plan.bn)
        resident = paper_suite.tinymatsum_blocks_per_sm(code, static, 3, 3, smem, dev)
        assert plan.grid == min(-(-8_000_000 // plan.bn), resident * sms)


def _offset_view(t, elems):
    """t's values in a buffer that starts ``elems`` elements into a fresh
    allocation (off a 16-byte boundary for elems * size % 16 != 0)."""
    flat = torch.empty(t.numel() + elems, dtype=t.dtype, device="cuda")
    flat[elems:] = t.reshape(-1)
    return flat[elems:].view(t.shape)


# (dtype, elements off): f32 4, 8, 12 bytes off; bf16 2 bytes off
TINY_OFFSETS = [(torch.float32, 1), (torch.float32, 2), (torch.float32, 3),
                (torch.bfloat16, 1)]


@pytest.mark.parametrize("dt_off", TINY_OFFSETS, ids=["f32+4", "f32+8", "f32+12", "bf16+2"])
@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("which", ["both", "o", "s"])
def test_tinymatsum_off_16_bytes_takes_the_scalar_form(dt_off, static, which):
    """Views whose data_ptr lies off 16 bytes plan the scalar staging form,
    run the kernel (one launch) and give the plain version's bits; a plan
    that asks for the vector form there is refused."""
    dtype, off = dt_off
    fn = ttiny.tinymatsum_static if static else ttiny.tinymatsum_dynamic
    o, s = _randn((100_000, 3, 3), dtype, 13), _randn((100_000, 3, 3), dtype, 14)
    if which in ("both", "o"):
        o = _offset_view(o, off)
    if which in ("both", "s"):
        s = _offset_view(s, off)
    assert (o.data_ptr() % 16 != 0) or (s.data_ptr() % 16 != 0)
    n = fn.launches
    got = fn(o, s)
    torch.cuda.synchronize()
    assert fn.launches == n + 1
    assert torch.equal(got, ttiny.tinymatsum_torch(o, s))
    plan = ttiny.plan_tinymatsum(100_000, 3, 3, o.element_size(), True, 132, lambda smem: 1)
    with pytest.raises(RuntimeError, match="launch failed"):
        fn(o, s, plan=plan)


@pytest.mark.parametrize("static", [True, False], ids=["static", "dynamic"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_tinymatsum_two_runs_give_the_same_bits(static, dtype):
    fn = ttiny.tinymatsum_static if static else ttiny.tinymatsum_dynamic
    o, s = _randn((1_000_003, 3, 3), dtype, 15), _randn((1_000_003, 3, 3), dtype, 16)
    first, second = fn(o, s), fn(o, s)
    assert torch.equal(first, second)
    assert torch.equal(first, ttiny.tinymatsum_torch(o, s))


# (N, J, K, dtype): staged past 48 KB (the opt-in), then unstaged (the fewest
# whole chunks of both operands pass a block's shared memory)
TINY_LARGE = [(37, 100, 100, torch.float32), (23, 90, 90, torch.bfloat16),
              (50, 101, 101, torch.float32), (9, 200, 200, torch.float32),
              (5, 300, 300, torch.bfloat16), (3, 1, 100_000, torch.float32)]


@pytest.mark.parametrize("case", TINY_LARGE, ids=[f"{n}x{j}x{k}" for n, j, k, _ in TINY_LARGE])
def test_tinymatsum_dynamic_takes_large_matrices(case):
    """The dynamic kernel at J K past any stage: the opt-in stage where the
    fewest whole chunks fit, the unstaged form where they do not (aligned
    and off 16 bytes); one launch each, bit-equal to the plain version."""
    n, j, k, dtype = case
    o, s = _randn((n, j, k), dtype, 19), _randn((n, j, k), dtype, 20)
    esz = o.element_size()
    unit = 16 // math.gcd(j * k * esz, 16)
    staged = ttiny.stage_bytes(j, k, esz, unit) <= paper_suite.GEOMETRY["smem_opt_in"]
    assert (ttiny.plan_for(o, s, o, False).bn == 0) == (not staged)
    for a, b in ((o, s), (_offset_view(o, 1), _offset_view(s, 1))):
        before = ttiny.tinymatsum_dynamic.launches
        got = ttiny.tinymatsum_dynamic(a, b, jmax=j, kmax=k)
        torch.cuda.synchronize()
        assert ttiny.tinymatsum_dynamic.launches == before + 1
        assert torch.equal(got, ttiny.tinymatsum_torch(a, b))


def test_tinymatsum_past_2_31_elements():
    """bf16 (N, 8, 8) with N J K past 2^31 (4.3 GB an operand): the int64
    offsets; compared with the plain version a slice at a time."""
    n = (1 << 31) // 64 + 4099
    g = torch.Generator(device="cuda").manual_seed(17)
    o = torch.empty(n, 8, 8, dtype=torch.bfloat16, device="cuda")
    s = torch.empty_like(o)
    for t in (o, s):
        for a in range(0, n, 1 << 22):
            t[a:a + (1 << 22)] = torch.randn(min(1 << 22, n - a), 8, 8, generator=g,
                                             device="cuda").to(torch.bfloat16)
    assert o.numel() > 1 << 31
    for fn in (ttiny.tinymatsum_static, ttiny.tinymatsum_dynamic):
        got = fn(o, s)
        for a in range(0, n, 1 << 22):
            sl = slice(a, a + (1 << 22))
            assert torch.equal(got[sl], ttiny.tinymatsum_torch(o[sl], s[sl])), (fn.__name__, a)
        del got
        torch.cuda.empty_cache()


def test_tinymatsum_static_refuses_uninstantiated_extents():
    o = _randn((4, 9, 3), torch.float32, 6)
    with pytest.raises(ValueError, match="instantiated"):
        ttiny.tinymatsum_static(o, o)
    torch.testing.assert_close(ttiny.tinymatsum_dynamic(o, o, jmax=9), o + o)


# (I, J): one element, small, no multiple of 4, 8 or 128 in either extent,
# a left run of rows split across blocks (257 x 1000: 3 splits of j on an
# H100), a J split into many (2048^2: 8) and a ragged tail of a right row
MATVEC_SHAPES = [(1, 1), (3, 5), (8, 128), (200, 384), (257, 1000), (1000, 257),
                 (2048, 2048), (129, 4099)]


def _matvec_operands(shape, layout, dtype, offset=0):
    """A (logical (I, J)), its stored buffer for ``layout`` and x, each
    buffer starting ``offset`` elements into a fresh allocation (offset 1:
    off a 16-byte boundary)."""
    a, x = _randn(shape, dtype, 7), _randn(shape[1:], dtype, 8)
    buf = a if layout == "right" else a.t().contiguous()

    def shifted(t):
        flat = torch.empty(t.numel() + offset, dtype=dtype, device="cuda")
        flat[offset:] = t.reshape(-1)
        return flat[offset:].view(t.shape)

    return a, shifted(buf), shifted(x)


@pytest.mark.parametrize("shape", MATVEC_SHAPES, ids=_ids(MATVEC_SHAPES))
@pytest.mark.parametrize("layout", ["right", "left"])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "off16"])
def test_matvec_kernels_match_plain(shape, layout, dtype, offset):
    """Aligned buffers and buffers off a 16-byte boundary (the scalar-load
    form) agree with the plain version, and two runs on one input give the
    same bits (no float atomics; the left split depends on the shapes
    only)."""
    a, buf, x = _matvec_operands(shape, layout, dtype, offset)
    assert (buf.data_ptr() % 16 == 0) == (offset == 0)
    fn = tmv.matvec_right if layout == "right" else tmv.matvec_left
    n = fn.launches
    got, again = fn(buf, x), fn(buf, x)
    torch.cuda.synchronize()
    assert fn.launches == n + 2 and got.dtype == dtype and got.shape == shape[:1]
    assert torch.equal(got, again)
    want = tmv.matvec_torch(a, x)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)
    else:
        assert _within_one_bf16_ulp(got, want, atol=2e-4)


def test_matvec_left_plan_splits_j_only_where_the_rows_are_few():
    sms = pa.sm_count(torch.device("cuda"))
    assert tmv.plan_matvec_left(16384, 16384, 4, sms)[0] == -(-2 * sms // 128)
    assert tmv.plan_matvec_left(1 << 20, 64, 4, sms) == (1, 64)


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


# ---------------------------------------------------------------------------------
# dense-cache attention (flash_attention, flash_decode) and the SSD scan
# ---------------------------------------------------------------------------------
# (B, hq, hkv, Tq, Tk, D): the reference's sweep shapes, Tq != Tk, D 128, and
# the qwen2 serve shapes (the generate phase's prefill, the engine's padded
# 512-token prompt)
FLASH_CASES = [(2, 4, 4, 64, 64, 32), (2, 4, 2, 64, 64, 32), (2, 8, 1, 64, 64, 32),
               (1, 2, 2, 32, 48, 16), (2, 16, 2, 40, 100, 128), (2, 14, 2, 256, 256, 64),
               (1, 14, 2, 512, 512, 64)]
FLASH_MASKS = [(True, None), (True, 24), (False, None)]
# (B, hq, hkv, S, D), decoded at POSITIONS (clipped to S - 1)
DECODE_DENSE_CASES = [(2, 4, 2, 128, 32), (8, 14, 2, 288, 64), (2, 16, 2, 100, 128)]
POSITIONS = [0, 31, 57, 127, 287]
# (b, t, h, p, n): the reference's sweep shapes, a ragged t, a p that is no
# multiple of the kernel's 32-column slice, and mamba2-780m's width; the
# chunk edges t = 1, 63, 64, 65 at that width; n 256 (MAX_STATE) with p 72
# (two slices and a ragged third) and n 16; the generate phase's B 2 x 389
# and B 4 x 512; n 5 and p 7 (rows off 16 bytes: the scalar staging and
# stores)
SSD_CASES = [(2, 128, 4, 16, 32), (1, 64, 8, 8, 16), (2, 100, 3, 40, 16), (1, 517, 4, 64, 128),
             (2, 512, 48, 64, 128), (1, 1, 48, 64, 128), (1, 63, 48, 64, 128),
             (1, 64, 48, 64, 128), (1, 65, 48, 64, 128), (1, 130, 4, 72, 256),
             (2, 150, 6, 48, 16), (2, 389, 48, 64, 128), (4, 512, 48, 64, 128),
             (2, 77, 3, 7, 5)]


def _rand(shape, dtype, seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32) * scale).to(
        "cuda", dtype)


def _assert_kernel_close(got, want, dtype):
    assert got.dtype == want.dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("case", FLASH_CASES, ids=_ids(FLASH_CASES))
@pytest.mark.parametrize("mask", FLASH_MASKS, ids=["causal", "window24", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_kernel_matches_plain(case, mask, dtype):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, tq, tk, d = case
    causal, window = mask
    q, k, v = (_rand((b, h, t, d), dtype, s) for s, (h, t) in
               enumerate(((hq, tq), (hkv, tk), (hkv, tk))))
    off = tk - tq  # the queries are the last tq positions
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    want = fa.attention_torch(q, k, v, causal=causal, window=window, q_offset=off)
    _assert_kernel_close(got, want, dtype)


def test_flash_attention_reads_a_device_offset_and_zeroes_masked_rows():
    from repro_torch.kernels import flash_attention as fa

    q, k, v = _rand((2, 4, 9, 32), torch.float32, 1), _rand((2, 2, 14, 32), torch.float32, 2), \
        _rand((2, 2, 14, 32), torch.float32, 3)
    for off in (5, -3):  # -3: the first three query rows see no key at all
        got = fa.flash_attention(q, k, v, q_offset=torch.tensor(off, device="cuda"))
        want = fa.attention_torch(q, k, v, q_offset=off)
        torch.testing.assert_close(got, want, **TOL)
    assert torch.count_nonzero(got[:, :, :3]) == 0


@pytest.mark.parametrize("case", DECODE_DENSE_CASES, ids=_ids(DECODE_DENSE_CASES))
@pytest.mark.parametrize("window", [None, 24], ids=["full", "window24"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_kernel_matches_plain(case, window, dtype):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, s, d = case
    q, kc, vc = _rand((b, hq, 1, d), dtype, 4), _rand((b, hkv, s, d), dtype, 5), \
        _rand((b, hkv, s, d), dtype, 6)
    for pos in sorted({min(p, s - 1) for p in POSITIONS}):
        for p in (pos, torch.tensor(pos, dtype=torch.int32, device="cuda")):
            n = fa.flash_decode.launches
            got = fa.flash_decode(q, kc, vc, p, window=window)
            torch.cuda.synchronize()
            assert fa.flash_decode.launches == n + 1
            want = fa.decode_attention_torch(q, kc, vc, pos, window=window)
            _assert_kernel_close(got, want, dtype)


def test_flash_wrappers_refuse_what_the_kernels_do_not_take():
    from repro_torch.kernels import flash_attention as fa

    q, k = _rand((1, 4, 8, 32), torch.float32, 7), _rand((1, 2, 8, 32), torch.float32, 8)
    with pytest.raises(TypeError):
        fa.flash_attention(q, k.to(torch.bfloat16), k)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, k.transpose(2, 3).contiguous().transpose(2, 3), k)
    with pytest.raises(ValueError, match="head dim"):
        fa.flash_attention(q[..., :8].contiguous(), k[..., :8].contiguous(),
                           k[..., :8].contiguous())
    with pytest.raises(ValueError, match="one query token"):
        fa.flash_decode(q, k, k, 3)
    with pytest.raises(ValueError, match="window"):
        fa.flash_attention(q, k, k, window=0)


# the split-K decode over the dense cache: every head dim, groups of 1, 7, 10
# and 16 (two 8-row blocks from 9 on), caches of 1 to 2600 slots
SPLIT_DENSE_S = [1, 37, 288, 2048, 2600]


@pytest.mark.parametrize("d", [16, 32, 64, 112, 128, 256])
@pytest.mark.parametrize("group", [1, 7, 10, 16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_split_matches_plain_on_and_off_split_edges(d, group, dtype):
    """pos 0, one before, on and one past the plan's first split edge, and
    S - 1, with and without a window, the position read on the device."""
    from repro_torch.kernels import flash_attention as fa

    assert d in fa.HEAD_DIMS
    b, hkv = 2, 1 if group == 10 else 2
    sms = pa.sm_count(torch.device("cuda"))
    for s in SPLIT_DENSE_S:
        q = _rand((b, hkv * group, 1, d), dtype, s)
        kc, vc = _rand((b, hkv, s, d), dtype, s + 1), _rand((b, hkv, s, d), dtype, s + 2)
        _, kps = pa.plan_decode_splits(s, b, hkv, 1, d, sms)
        for pos in sorted({min(p, s - 1) for p in (0, kps - 1, kps, kps + 1, s - 1)}):
            pos_t = torch.tensor([pos], dtype=torch.int32, device="cuda")
            for window in (None, 24):
                n = fa.flash_decode.launches
                got = fa.flash_decode(q, kc, vc, pos_t, window=window)
                torch.cuda.synchronize()
                assert fa.flash_decode.launches == n + 1
                _assert_kernel_close(got, fa.decode_attention_torch(q, kc, vc, pos, window=window),
                                     dtype)


# (B, hq, hkv, S, D): recurrentgemma's ring, qwen2's generate cache, D 128
# with two row blocks, and a cache shorter than one split
DENSE_WS_CASES = [(2, 10, 1, 2048, 256), (8, 14, 2, 288, 64), (2, 16, 2, 100, 128),
                  (3, 7, 1, 37, 32)]


@pytest.mark.parametrize("case", DENSE_WS_CASES, ids=_ids(DENSE_WS_CASES))
@pytest.mark.parametrize("window", [None, 24], ids=["full", "window24"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_workspace_matches_the_plain_partials(case, window, dtype, monkeypatch):
    """The decode kernel's workspace (m, l, acc of every split) against
    decode_partials_torch on the same f32 values, at a position on a split
    edge (so later splits, and with a window earlier ones, are dead: l = 0,
    m = -inf), and the combine kernel's output against combine_splits_torch
    over that workspace, as the paged decode's workspace is held."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, s, d = case
    q, kc, vc = _rand((b, hq, 1, d), dtype, 51), _rand((b, hkv, s, d), dtype, 52), \
        _rand((b, hkv, s, d), dtype, 53)
    seen = {}

    def spy(*a):
        seen["plan"] = plan = real(*a)
        return plan

    real = pa._decode_split
    monkeypatch.setattr(pa, "_decode_split", spy)
    _, kps = pa.plan_decode_splits(s, b, hkv, 1, d, pa.sm_count(torch.device("cuda")))
    pos = min(kps * 3, s - 1)
    got = fa.flash_decode(q, kc, vc, torch.tensor([pos], dtype=torch.int32, device="cuda"),
                          window=window)
    torch.cuda.synchronize()
    splits, kps, ws = seen["plan"]
    n = b * hq * splits
    m, l = ws[:n].view(b, hq, splits), ws[n:2 * n].view(b, hq, splits)
    acc = ws[2 * n:].view(b, hq, splits, d)
    wm, wl, wacc = fa.decode_partials_torch(q, kc.float(), vc.float(), pos, keys_per_split=kps,
                                            window=window)
    live = wl > 0
    assert torch.equal(l > 0, live)
    assert torch.all(l[~live] == 0) and torch.all(m[~live] == -float("inf"))
    torch.testing.assert_close(m[live], wm[live], **TOL)
    torch.testing.assert_close(l[live], wl[live], rtol=2e-5, atol=0)
    torch.testing.assert_close(acc[live] / l[live][:, None], wacc[live] / wl[live][:, None], **TOL)
    _assert_kernel_close(got, pa.combine_splits_torch(m, l, acc).to(dtype)[:, :, None], dtype)


def test_flash_decode_takes_any_group_up_to_the_grid_limit():
    """A GQA group of 72 query heads (above the 64 rows the unsplit decode
    block held) runs in ceil(72 / 8) row blocks; a group whose row blocks
    pass the grid's 65535 is refused by the launch, not run wrong."""
    from repro_torch.kernels import flash_attention as fa

    q, kc, vc = _rand((1, 72, 1, 64), torch.float32, 54), _rand((1, 1, 100, 64), torch.float32, 55), \
        _rand((1, 1, 100, 64), torch.float32, 56)
    _assert_kernel_close(fa.flash_decode(q, kc, vc, 60), fa.decode_attention_torch(q, kc, vc, 60),
                         torch.float32)
    big = torch.zeros(1, 8 * 65536, 1, 16, device="cuda")
    with pytest.raises(RuntimeError, match="flash_decode launch failed"):
        fa.flash_decode(big, kc[..., :16].contiguous(), vc[..., :16].contiguous(), 3)


def _ssd_inputs(b, t, h, p, n, dtype, seed, decay=1.0):
    """x, dt, A, B, C, s0; ``decay`` > 1 scales dt's spread and |A| up
    (dt softplus(decay N(0, 1)), A -2 decay e^(0.3 N(0, 1)))."""
    rng = np.random.default_rng(seed)
    f = lambda *s, sc=1.0: torch.from_numpy(rng.standard_normal(s).astype(np.float32) * sc)
    x = f(b, t, h, p, sc=0.5).to("cuda", dtype)
    dt = torch.nn.functional.softplus(f(b, t, h, sc=decay)).cuda()
    A = (-torch.exp(f(h, sc=0.3)) * (2 * decay if decay > 1 else 1.0)).cuda()
    B = f(b, t, 1, n, sc=0.3).to("cuda", dtype)
    C = f(b, t, 1, n, sc=0.3).to("cuda", dtype)
    s0 = f(b, h, p, n, sc=0.5).cuda()
    return x, dt, A, B, C, s0


@pytest.mark.parametrize("case", SSD_CASES, ids=_ids(SSD_CASES))
@pytest.mark.parametrize("initial", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_scan_kernel_matches_plain(case, initial, dtype):
    """The kernel (64-step chunks) against the plain version at chunk 16 and
    at chunk = t (the model's ragged-prompt setting): y and the final state.
    f32 within rtol/atol 1e-4 (two chunkings sum in other orders); bf16 y
    within one bf16 ulp + 1e-4 of the plain output."""
    from repro_torch.kernels import ssd_scan as ss

    x, dt, A, B, C, s0 = _ssd_inputs(*case, dtype=dtype, seed=sum(case))
    init = s0 if initial else None
    n = ss.ssd_scan.launches
    y, st = ss.ssd_scan(x, dt, A, B, C, initial_state=init, return_final_state=True)
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == n + 1 and y.dtype == dtype and st.dtype == torch.float32
    for chunk in (16, case[1]):
        wy, ws = ss.ssd_torch(x, dt, A, B, C, chunk=chunk, initial_state=init,
                              return_final_state=True)
        torch.testing.assert_close(st, ws, rtol=1e-4, atol=1e-4)
        if dtype == torch.float32:
            torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
        else:
            assert _within_one_bf16_ulp(y, wy, atol=1e-4)


def _ssd_close(kernel_out, plain_out, dtype):
    """The kernel's y and final state against the plain version's: the state
    rtol/atol 1e-4, y likewise in f32 and within one bf16 ulp + 1e-4 in
    bf16."""
    (y, st), (wy, ws) = kernel_out, plain_out
    torch.testing.assert_close(st, ws, rtol=1e-4, atol=1e-4)
    if dtype == torch.float32:
        torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
    else:
        assert _within_one_bf16_ulp(y, wy, atol=1e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_scan_strong_decay_underflows_inside_a_chunk(dtype):
    """dt |A| up to ~45 (mean ~4.5): exp(s) underflows to 0 inside most 64-step
    chunks, and exp(min(s_t - s_u, 0)) keeps every term finite; against the
    plain version at chunk 16 and chunk = t, with an initial state."""
    from repro_torch.kernels import ssd_scan as ss

    x, dt, A, B, C, s0 = _ssd_inputs(2, 130, 4, 64, 128, dtype, 5, decay=2.0)
    assert float((dt * -A).max()) > 30
    got = ss.ssd_scan(x, dt, A, B, C, initial_state=s0, return_final_state=True)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(o.float()).all()) for o in got)
    for chunk in (16, 130):
        _ssd_close(got, ss.ssd_torch(x, dt, A, B, C, chunk=chunk, initial_state=s0,
                                     return_final_state=True), dtype)


@pytest.mark.parametrize("case", [(2, 389, 48, 64, 128), (1, 130, 4, 72, 256)],
                         ids=["mamba2_b2x389", "n256"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ssd_scan_two_runs_give_the_same_bits(case, dtype):
    """No float atomics: y and the final state are bit-equal from run to run."""
    from repro_torch.kernels import ssd_scan as ss

    x, dt, A, B, C, s0 = _ssd_inputs(*case, dtype=dtype, seed=21)
    y1, s1 = ss.ssd_scan(x, dt, A, B, C, initial_state=s0, return_final_state=True)
    y2, s2 = ss.ssd_scan(x, dt, A, B, C, initial_state=s0, return_final_state=True)
    torch.cuda.synchronize()
    assert torch.equal(y1, y2) and torch.equal(s1, s2)


def test_ssd_scan_counts_one_launch_a_call():
    """The C . B kernel and the scan kernel launch from one C entry: a call
    counts once, in ssd_scan.launches and in launch_counts()."""
    from repro_torch.kernels import ssd_scan as ss

    x, dt, A, B, C, _ = _ssd_inputs(1, 130, 4, 64, 128, torch.bfloat16, 22)
    kernels.reset_launch_counts()
    for _ in range(3):
        ss.ssd_scan(x, dt, A, B, C)
    torch.cuda.synchronize()
    assert ss.ssd_scan.launches == 3 and kernels.launch_counts()["ssd_scan"] == 3


@pytest.mark.parametrize("batch", [2, 4])
def test_ssd_scan_grid_fills_the_card_in_one_wave(batch):
    """At mamba2-780m's width in bf16 (the generate phase's dtype), B 2 and 4:
    the scan's blocks cover every SM, and all of them are resident at once
    (the library's occupancy query)."""
    from repro_torch.kernels import ssd_scan as ss

    dev = torch.device("cuda")
    sms = pa.sm_count(dev)
    blocks = ss.grid_blocks(batch, 48, 64)
    assert sms <= blocks <= ss.blocks_per_sm(torch.bfloat16, 128, dev) * sms
    assert ss.blocks_per_sm(torch.float32, 128, dev) >= 1
    assert ss.blocks_per_sm(torch.bfloat16, ss.MAX_STATE, dev) >= 1
    assert ss.blocks_per_sm(torch.float32, ss.MAX_STATE, dev) >= 1


def test_ssd_scan_state_chaining_matches_full_run():
    from repro_torch.kernels import ssd_scan as ss

    x, dt, A, B, C, _ = _ssd_inputs(1, 200, 4, 32, 64, torch.float32, 9)
    y_full, s_full = ss.ssd_scan(x, dt, A, B, C, return_final_state=True)
    y1, s1 = ss.ssd_scan(x[:, :77].contiguous(), dt[:, :77].contiguous(), A,
                         B[:, :77].contiguous(), C[:, :77].contiguous(), return_final_state=True)
    y2, s2 = ss.ssd_scan(x[:, 77:].contiguous(), dt[:, 77:].contiguous(), A,
                         B[:, 77:].contiguous(), C[:, 77:].contiguous(), initial_state=s1,
                         return_final_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(s2, s_full, rtol=1e-4, atol=1e-4)


def test_ssd_scan_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels import ssd_scan as ss

    x, dt, A, B, C, _ = _ssd_inputs(1, 16, 2, 8, 16, torch.float32, 10)
    with pytest.raises(ValueError, match="ngroups 1"):
        ss.ssd_scan(x, dt, A, B.expand(1, 16, 2, 16).contiguous(), C)
    with pytest.raises(TypeError):
        ss.ssd_scan(x, dt.double(), A, B, C)
    with pytest.raises(TypeError):
        ss.ssd_scan(x, dt, A, B.to(torch.bfloat16), C)
    with pytest.raises(ValueError, match="contiguous"):
        ss.ssd_scan(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C)


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_ops_dense_paths_launch_the_kernels(impl):
    """ops.attention / decode_attention / ssd under "auto" and "cuda" launch
    their kernels on CUDA tensors; "torch" launches nothing."""
    q, k = _rand((1, 4, 8, 32), torch.float32, 11), _rand((1, 2, 8, 32), torch.float32, 12)
    x, dt, A, B, C, _ = _ssd_inputs(1, 16, 2, 8, 16, torch.float32, 13)
    for mode, want in ((impl, 1), ("torch", 0)):
        kernels.reset_launch_counts()
        ops.attention(q, k, k, impl=mode)
        ops.decode_attention(q[:, :, :1].contiguous(), k, k, 5, impl=mode)
        ops.ssd(x, dt, A, B, C, chunk=8, impl=mode)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        assert [counts[n] for n in ("flash_attention", "flash_decode", "ssd_scan")] == [want] * 3


def test_ops_ssd_with_groups_raises_under_cuda_and_runs_plain_under_auto():
    """ngroups > 1: impl="cuda" refuses (the kernel takes ngroups 1 only);
    "auto" runs the plain chunked version, as the reference dispatches."""
    from repro_torch.kernels import ssd_scan as ss

    x, dt, A, B, C, _ = _ssd_inputs(1, 16, 2, 8, 16, torch.float32, 14)
    B2, C2 = B.expand(1, 16, 2, 16).contiguous(), C.expand(1, 16, 2, 16).contiguous()
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="ngroups 1"):
        ops.ssd(x, dt, A, B2, C2, chunk=8, impl="cuda")
    y = ops.ssd(x, dt, A, B2, C2, chunk=8, impl="auto")
    torch.cuda.synchronize()
    assert kernels.launch_counts()["ssd_scan"] == 0
    torch.testing.assert_close(y, ss.ssd_torch(x, dt, A, B2, C2, chunk=8))


# ---------------------------------------------------------------------------------
# recurrentgemma: rglru_scan, and the flash kernels at head dim 256 over a ring
# ---------------------------------------------------------------------------------
# (B, T, W): small, ragged T (no multiple of the kernel's 16-step unroll), a
# T shorter than the unroll, and recurrentgemma-2b's width
RGLRU_CASES = [(2, 32, 16), (1, 64, 128), (2, 37, 24), (3, 5, 40), (2, 600, 2560)]


def _rglru_inputs(b, t, w, dtype, seed):
    rng = np.random.default_rng(seed)
    a = torch.from_numpy(rng.uniform(0.5, 1.0, (b, t, w)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((b, t, w)).astype(np.float32))
    bterm = torch.sqrt(1 - a * a) * x
    h0 = torch.from_numpy(rng.standard_normal((b, w)).astype(np.float32)).cuda()
    return a.to("cuda", dtype), bterm.to("cuda", dtype), h0


@pytest.mark.parametrize("case", RGLRU_CASES, ids=_ids(RGLRU_CASES))
@pytest.mark.parametrize("initial", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rglru_scan_kernel_matches_plain(case, initial, dtype):
    """The sequential kernel against the plain associative scan: f32 y and the
    f32 final state within rtol/atol 1e-5 (two summation trees); bf16 y within
    one bf16 ulp + 1e-5 of the plain output."""
    from repro_torch.kernels import rglru_scan as rs

    a, b, h0 = _rglru_inputs(*case, dtype=dtype, seed=sum(case))
    init = h0 if initial else None
    n = rs.rglru_scan.launches
    y, hf = rs.rglru_scan(a, b, initial_state=init, return_final_state=True)
    torch.cuda.synchronize()
    assert rs.rglru_scan.launches == n + 1 and y.dtype == dtype and hf.dtype == torch.float32
    wy, whf = rs.rglru_torch(a, b, init, return_final_state=True)
    torch.testing.assert_close(hf, whf, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-5)
    else:
        assert _within_one_bf16_ulp(y, wy, atol=1e-5)


def test_rglru_scan_state_chaining_matches_full_run():
    from repro_torch.kernels import rglru_scan as rs

    a, b, _ = _rglru_inputs(2, 301, 256, torch.float32, 21)
    y_full, h_full = rs.rglru_scan(a, b, return_final_state=True)
    y1, h1 = rs.rglru_scan(a[:, :150].contiguous(), b[:, :150].contiguous(),
                           return_final_state=True)
    y2, h2 = rs.rglru_scan(a[:, 150:].contiguous(), b[:, 150:].contiguous(), initial_state=h1,
                           return_final_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y_full, rtol=0, atol=0)
    torch.testing.assert_close(h2, h_full, rtol=0, atol=0)


def test_rglru_scan_refuses_what_the_kernel_does_not_take():
    from repro_torch.kernels import rglru_scan as rs

    a, b, h0 = _rglru_inputs(1, 8, 16, torch.float32, 22)
    with pytest.raises(ValueError, match="CUDA"):
        ops.rglru_scan(a.cpu(), b.cpu(), impl="cuda")
    with pytest.raises(TypeError):
        rs.rglru_scan(a, b.to(torch.bfloat16))
    with pytest.raises(TypeError):
        rs.rglru_scan(a.double(), b.double())
    with pytest.raises(ValueError, match="contiguous"):
        rs.rglru_scan(a.transpose(1, 2).contiguous().transpose(1, 2), b)
    with pytest.raises(TypeError):
        rs.rglru_scan(a, b, initial_state=h0.to(torch.bfloat16))


@pytest.mark.parametrize("impl", ["auto", "cuda"])
def test_ops_rglru_scan_launches_the_kernel(impl):
    a, b, _ = _rglru_inputs(1, 8, 16, torch.float32, 23)
    for mode, want in ((impl, 1), ("torch", 0)):
        kernels.reset_launch_counts()
        ops.rglru_scan(a, b, impl=mode)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["rglru_scan"] == want


# The staged chain's edges (a stage is 32 steps of 32 columns): recurrentgemma-
# 2b's prompts; T 1, 31, 32, 33 and 5 (shorter than a stage); W no multiple of
# 32 (40, 2561: in bf16 2561 leaves every row off 16 bytes, so the ring takes
# plain loads); bf16 W odd (33); B 1 (8 blocks, under the SM count); B x W
# past what the card holds at once (4096 blocks, one a work item: several waves)
RGLRU_EDGE_CASES = [(2, 2600, 2560), (2, 2040, 2560), (2, 1, 64), (2, 31, 64), (2, 32, 64),
                    (2, 33, 64), (3, 5, 96), (2, 70, 40), (1, 45, 2561), (2, 40, 33),
                    (1, 64, 256), (8, 40, 16384)]


@pytest.mark.parametrize("case", RGLRU_EDGE_CASES, ids=_ids(RGLRU_EDGE_CASES))
@pytest.mark.parametrize("initial", [False, True], ids=["zero_state", "initial_state"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rglru_scan_stage_edges_match_plain(case, initial, dtype):
    """The kernel against the plain scan at the ring's edges, with the
    existing test's tolerance (f32 1e-5; bf16 y one ulp + 1e-5)."""
    from repro_torch.kernels import rglru_scan as rs

    a, b, h0 = _rglru_inputs(*case, dtype=dtype, seed=sum(case) + 1)
    init = h0 if initial else None
    y, hf = rs.rglru_scan(a, b, initial_state=init, return_final_state=True)
    torch.cuda.synchronize()
    wy, whf = rs.rglru_torch(a, b, init, return_final_state=True)
    torch.testing.assert_close(hf, whf, rtol=1e-5, atol=1e-5)
    if dtype == torch.float32:
        torch.testing.assert_close(y, wy, rtol=1e-5, atol=1e-5)
    else:
        assert _within_one_bf16_ulp(y, wy, atol=1e-5)


@pytest.mark.parametrize("case", [(2, 2600, 2560, 1299), (2, 77, 96, 33), (3, 100, 40, 63)],
                         ids=["rg2b_2600_at_1299", "t77_at_33", "w40_t100_at_63"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rglru_scan_chained_halves_are_bit_equal_off_stage_edges(case, dtype):
    """Split at a T that is no multiple of the 32-step stage, from an initial
    state: the second half's chain starts from the first's f32 state, so the
    two halves give one run's bits (y and the final state)."""
    from repro_torch.kernels import rglru_scan as rs

    bsz, t, w, cut = case
    a, b, h0 = _rglru_inputs(bsz, t, w, dtype, 40 + t)
    y_full, h_full = rs.rglru_scan(a, b, initial_state=h0, return_final_state=True)
    y1, h1 = rs.rglru_scan(a[:, :cut].contiguous(), b[:, :cut].contiguous(), initial_state=h0,
                           return_final_state=True)
    y2, h2 = rs.rglru_scan(a[:, cut:].contiguous(), b[:, cut:].contiguous(), initial_state=h1,
                           return_final_state=True)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([y1, y2], 1), y_full) and torch.equal(h2, h_full)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_rglru_scan_two_runs_and_every_form_give_the_same_bits(dtype):
    """Two runs are bit-equal and count one launch each; a view off 16 bytes
    (the ring's plain loads) gives the 16-byte copies' bits."""
    from repro_torch.kernels import rglru_scan as rs

    a, b, h0 = _rglru_inputs(2, 300, 320, dtype, 51)
    kernels.reset_launch_counts()
    y1, s1 = rs.rglru_scan(a, b, initial_state=h0, return_final_state=True)
    y2, s2 = rs.rglru_scan(a, b, initial_state=h0, return_final_state=True)
    torch.cuda.synchronize()
    assert rs.rglru_scan.launches == 2 and kernels.launch_counts()["rglru_scan"] == 2
    assert torch.equal(y1, y2) and torch.equal(s1, s2)
    av, bv = _offset_view(a, 1), _offset_view(b, 1)
    assert av.data_ptr() % 16 != 0
    yv, sv = rs.rglru_scan(av, bv, initial_state=h0, return_final_state=True)
    assert torch.equal(yv, y1) and torch.equal(sv, s1)


# (B, hq, hkv, T, D, window): recurrentgemma's MQA heads at D 256, rg-smoke's
# window 8 and the full config's 2048 (T past it, so the band is cut)
FLASH_256_CASES = [(2, 10, 1, 40, 256, 8), (1, 10, 1, 2100, 256, 2048), (2, 10, 1, 77, 256, None)]


@pytest.mark.parametrize("case", FLASH_256_CASES, ids=_ids(FLASH_256_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_head_dim_256_matches_plain(case, dtype):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, t, d, window = case
    q, k, v = _rand((b, hq, t, d), dtype, 24), _rand((b, hkv, t, d), dtype, 25), \
        _rand((b, hkv, t, d), dtype, 26)
    got = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    _assert_kernel_close(got, fa.attention_torch(q, k, v, window=window), dtype)


def ring_decode_reference(q, ring_k, ring_v, pos: int, window: int):
    """The reference's windowed decode attention (models/attention.py, eager
    masked einsum): ring slot i holds absolute position pos - ((pos % S - i)
    mod S), live when it lies in [max(pos - window + 1, 0), pos]."""
    s = ring_k.shape[2]
    idx = torch.arange(s, device=q.device)
    abs_pos = pos - ((pos % s - idx) % s)
    live = (abs_pos >= max(pos - window + 1, 0)) & (abs_pos <= pos)
    group = q.shape[1] // ring_k.shape[1]
    kf = ring_k.float().repeat_interleave(group, dim=1)
    vf = ring_v.float().repeat_interleave(group, dim=1)
    sc = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) / np.sqrt(q.shape[-1])
    sc = torch.where(live, sc, torch.full_like(sc, -1e30))
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(sc, dim=-1), vf).to(q.dtype)


@pytest.mark.parametrize("window", [8, 2048])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_decode_on_a_ring_matches_the_reference_mask(window, dtype):
    """flash_decode at D 256, hq 10 / hkv 1, over a full ring of ``window``
    random slots at min(pos, S - 1) with no window — the port's windowed
    decode — against the plain version at the same position and against the
    reference's ring mask: before the wrap, at it and after it."""
    from repro_torch.kernels import flash_attention as fa

    q = _rand((2, 10, 1, 256), dtype, 27)
    ring_k, ring_v = _rand((2, 1, window, 256), dtype, 28), _rand((2, 1, window, 256), dtype, 29)
    for pos in (0, window // 2 - 1, window - 1, window, window + 23, 3 * window + 5):
        last = torch.tensor([min(pos, window - 1)], dtype=torch.int32, device="cuda")
        got = fa.flash_decode(q, ring_k, ring_v, last)
        torch.cuda.synchronize()
        _assert_kernel_close(got, fa.decode_attention_torch(q, ring_k, ring_v, last), dtype)
        _assert_kernel_close(got, ring_decode_reference(q, ring_k, ring_v, pos, window),
                             dtype)


def test_hybrid_serve_on_cuda_matches_the_plain_path():
    """rg-smoke in f32 through make_prefill + make_serve_step on the card:
    the kernels (flash_attention, flash_decode, rglru_scan, all launched)
    give the plain path's greedy tokens; prompts wrap the window-8 ring in
    prefill (20) and in decode (6)."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import make_prefill, make_serve_step

    cfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    for length in (6, 20):
        toks = torch.from_numpy(np.random.default_rng(length).integers(
            0, cfg.vocab, size=(2, length))).cuda()
        runs = {}
        for impl in ("auto", "torch"):
            kernels.reset_launch_counts()
            logits, caches = make_prefill(model, max_len=length + 8, attn_impl=impl)(params, toks)
            step = make_serve_step(model, attn_impl=impl)
            nxt = torch.argmax(logits[:, -1, :cfg.vocab], -1).to(torch.int32)
            out = [nxt.tolist()]
            for i in range(7):
                logits, caches = step(params, caches, nxt, length + i)
                nxt = torch.argmax(logits[:, :cfg.vocab], -1).to(torch.int32)
                out.append(nxt.tolist())
            runs[impl] = (out, kernels.launch_counts())
        assert runs["auto"][0] == runs["torch"][0]
        need = ("flash_attention", "flash_decode", "rglru_scan")
        assert all(runs["auto"][1][k] > 0 for k in need), runs["auto"][1]
        assert all(runs["torch"][1][k] == 0 for k in need), runs["torch"][1]


# -------------------------------------------------------------------------------------
# the split-K paged decode (dense and intN pools, one body) and the bf16
# tensor-core prefill body of flash_attention
# -------------------------------------------------------------------------------------
# (batch, hq, hkv, d, page_size, max_pages): one split (the table is one
# tile), and many (the serve shape: 16 splits of 8 pages on an H100); groups
# of 12 heads take two of the kernel's 8-row blocks
SPLIT_CASES = [(4, 14, 2, 64, 16, 4), (8, 14, 2, 64, 16, 128), (3, 16, 2, 128, 16, 40),
               (2, 4, 2, 16, 4, 24), (2, 12, 1, 32, 8, 20), (2, 24, 2, 64, 16, 20)]


def _split_lens(batch, hq, hkv, d, ps, max_pages):
    """Lengths on a split boundary, one past it, inside the first split, a
    length-0 row and the full table, from the plan the wrapper will use."""
    splits, pps = pa.plan_decode_splits(max_pages, batch, hkv, ps, d,
                                        pa.sm_count(torch.device("cuda")))
    run = pps * ps
    full = max_pages * ps
    cands = [0, min(run, full), min(run + 1, full), max(1, run // 2), min(3 * run, full),
             min(3 * run + 1, full), full - 1, full]
    return splits, tuple(cands[i % len(cands)] for i in range(batch))


def _split_operands(case, pool, dtype):
    """(kernel, plain, args, kwargs, dense K/V pools as f32, lengths) of one
    split-decode case, from a seed."""
    b, hq, hkv, d, ps, max_pages = case
    _, lens = _split_lens(*case)
    rng = np.random.default_rng(max_pages)
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32)).to("cuda", dtype)
    num_pages = b * max_pages + 1
    bt = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).reshape(
        b, max_pages).astype(np.int32)).cuda()
    q, kp, vp = f(b, hq, 1, d), f(num_pages, hkv, ps, d), f(num_pages, hkv, ps, d)
    cl = torch.tensor(lens, dtype=torch.int32, device="cuda")
    if pool == "dense":
        return (pa.paged_flash_decode, pa.paged_decode_attention_torch, (q, kp, vp, bt, cl), {},
                (kp.float(), vp.float()), lens)
    bits = int(pool[3:])
    kq, vq = _quantize_pool(kp, bits), _quantize_pool(vp, bits)
    dense = tuple(pa.dequantize_pages(*x, bits=bits) for x in (kq, vq))
    return (pa.paged_flash_decode_quant, pa.paged_decode_attention_quant_torch,
            (q, *kq, *vq, bt, cl), {"bits": bits}, dense, lens)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=_ids(SPLIT_CASES))
@pytest.mark.parametrize("pool", ["dense", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_decode_matches_plain_on_and_off_split_boundaries(case, pool, dtype):
    _, _, _, d, ps, max_pages = case
    splits, _ = _split_lens(*case)
    assert (splits == 1) == (max_pages * ps <= (64 if d <= 64 else 32))
    kern, plain, args, kw, _, lens = _split_operands(case, pool, dtype)
    n = kern.launches
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == n + 1 and got.dtype == dtype
    _assert_kernel_close(got, plain(*args, **kw), dtype)
    for row, length in enumerate(lens):
        if length == 0:
            assert torch.count_nonzero(got[row]) == 0
    again = kern(*args, **kw)  # a fixed plan and order: the same bits every call
    torch.testing.assert_close(again, got, rtol=0, atol=0)


@pytest.mark.parametrize("case", SPLIT_CASES, ids=_ids(SPLIT_CASES))
@pytest.mark.parametrize("pool", ["dense", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_split_decode_partials_and_combine_match_their_plain_versions(case, pool, dtype,
                                                                      monkeypatch):
    """The decode kernel's workspace (m, l, acc of every split) against
    paged_decode_partials_torch on the same f32 pages, and
    combine_splits_torch over that workspace against the combine kernel's
    output. m within 2e-5, l within rtol 2e-5, acc / l (the split's own
    normalized output) within 2e-5; a split with no live token has l = 0 and
    m = -inf. The combine is held like the whole kernel (one bf16 ulp + 2e-5
    in bf16)."""
    kern, _, args, kw, (kd, vd), _ = _split_operands(case, pool, dtype)
    b, hq, _, d = args[0].shape
    seen = {}

    def spy(*a):
        seen["plan"] = plan = real(*a)
        return plan

    real = pa._decode_split
    monkeypatch.setattr(pa, "_decode_split", spy)
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    splits, pps, ws = seen["plan"]
    n = b * hq * splits
    m, l = ws[:n].view(b, hq, splits), ws[n:2 * n].view(b, hq, splits)
    acc = ws[2 * n:].view(b, hq, splits, d)
    q, bt, cl = args[0], args[-2], args[-1]
    wm, wl, wacc = pa.paged_decode_partials_torch(q, kd, vd, bt, cl, pages_per_split=pps)
    live = wl > 0
    assert torch.equal(l > 0, live)
    assert torch.all(l[~live] == 0) and torch.all(m[~live] == -float("inf"))
    torch.testing.assert_close(m[live], wm[live], **TOL)
    torch.testing.assert_close(l[live], wl[live], rtol=2e-5, atol=0)
    torch.testing.assert_close(acc[live] / l[live][:, None], wacc[live] / wl[live][:, None], **TOL)
    _assert_kernel_close(got, pa.combine_splits_torch(m, l, acc).to(dtype)[:, :, None], dtype)


def test_split_plan_at_the_serve_shape():
    splits, pps = pa.plan_decode_splits(128, 8, 2, 16, 64, pa.sm_count(torch.device("cuda")))
    assert splits * 8 * 2 >= pa.sm_count(torch.device("cuda")) and pps % 4 == 0


# (B, hq, hkv, T, D, window): Tq * G not a multiple of the kernel's 64 rows,
# at every head dim, and recurrentgemma's (1, 10, 2600, 256) at window 2048
FLASH_BF16_CASES = [(2, 6, 2, 37, 16, None), (2, 6, 2, 37, 32, 16), (1, 14, 2, 101, 64, None),
                    (2, 12, 4, 70, 128, 24), (2, 10, 1, 45, 256, None),
                    (1, 10, 1, 2600, 256, 2048)]


@pytest.mark.parametrize("case", FLASH_BF16_CASES, ids=_ids(FLASH_BF16_CASES))
def test_flash_attention_bf16_tensor_cores_match_plain(case):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, t, d, window = case
    assert (t * hq // hkv) % 64 or t == 2600
    q, k, v = _rand((b, hq, t, d), torch.bfloat16, 41), _rand((b, hkv, t, d), torch.bfloat16, 42), \
        _rand((b, hkv, t, d), torch.bfloat16, 43)
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    _assert_kernel_close(got, fa.attention_torch(q, k, v, window=window), torch.bfloat16)


def test_flash_attention_bf16_offsets_and_empty_rows():
    """A device offset, rows that see no key (output 0), Tq != Tk."""
    from repro_torch.kernels import flash_attention as fa

    q, k, v = (_rand(s, torch.bfloat16, i) for i, s in
               enumerate(((2, 4, 9, 64), (2, 2, 30, 64), (2, 2, 30, 64))))
    for off in (5, 21, -3):
        got = fa.flash_attention(q, k, v, q_offset=torch.tensor(off, device="cuda"))
        want = fa.attention_torch(q, k, v, q_offset=off)
        _assert_kernel_close(got, want, torch.bfloat16)
    assert torch.count_nonzero(got[:, :, :3]) == 0
    with pytest.raises(ValueError, match="16-byte"):
        flat = torch.empty(2 * 4 * 9 * 64 + 1, dtype=torch.bfloat16, device="cuda")
        fa.flash_attention(flat[1:].view(2, 4, 9, 64), k, v)


# ---------------------------------------------------------------------------------
# quant_matmul's schedules (stream, mma, fma) and the bf16 tensor-core chunk body
# ---------------------------------------------------------------------------------
# (M, N, K, qblock): decode rows 1-16 and chunk rows 17-130 at the MLP's two
# shapes and an N no multiple of any tile; K of one block; K split unevenly
# (896 = 512 + 384 at decode; 4864 over five splits at M 128)
QMM_SCHED_CASES = ([(m, n, k, 128) for m in (1, 8, 13, 16, 17, 128, 130)
                    for n, k in ((896, 4864), (4864, 896), (130, 896))]
                   + [(1, 896, 128, 128), (17, 896, 128, 128), (8, 130, 192, 64),
                      (40, 130, 192, 64), (5, 70, 96, 32), (20, 70, 96, 32)])


def _qmm_operands(m, n, k, qblock, bits, dtype, offset=0):
    """x, q, scale from a seed; ``offset`` puts q one byte past a 16-byte
    boundary (a contiguous tensor off 16 bytes)."""
    g = torch.Generator(device="cuda").manual_seed(m * 7 + n + k)
    x = torch.randn(m, k, generator=g, device="cuda").to(dtype)
    w = torch.randn(n, k, generator=g, device="cuda") / k ** 0.5
    bufs = quantize_array(w, QuantizedAccessor(torch.float32, bits=bits, block=qblock))
    q = bufs["q"]
    if offset:
        flat = torch.empty(q.numel() + 16, dtype=torch.int8, device="cuda")
        q2 = flat[offset:offset + q.numel()].view(q.shape)
        q2.copy_(q)
        q = q2
    return x, q, bufs["scale"]


@pytest.mark.parametrize("case", QMM_SCHED_CASES, ids=_ids(QMM_SCHED_CASES))
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_matmul_schedules_match_plain_and_repeat(case, bits, dtype):
    """Every schedule (stream, mma, fma) against the plain version
    (f32 2e-5, bf16 one ulp + 2e-5), the planned schedule as expected, and
    two calls bit-identical (a fixed split order, no atomics)."""
    m, n, k, qblock = case
    x, q, scale = _qmm_operands(m, n, k, qblock, bits, dtype)
    plan = qmm.plan_quant_matmul(m, n, k, qblock, bits, dtype,
                                 pa.sm_count(torch.device("cuda")))
    bf16 = dtype == torch.bfloat16
    assert plan.schedule == (("stream" if qblock % (64 * (8 // bits)) == 0 else "fma")
                             if bf16 and m <= 16 else "mma" if bf16 else "fma")
    launches = qmm.quant_matmul.launches
    got = qmm.quant_matmul(x, q, scale, bits=bits)
    torch.cuda.synchronize()
    assert qmm.quant_matmul.launches == launches + 1 and got.dtype == dtype
    assert qmm.quant_matmul.last_plan == plan
    want = qmm.quant_matmul_torch(x, q, scale, bits=bits)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)
    torch.testing.assert_close(qmm.quant_matmul(x, q, scale, bits=bits), got, rtol=0, atol=0)


@pytest.mark.parametrize("m", [8, 130])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_quant_matmul_takes_a_misaligned_q(m, bits, dtype):
    """q one byte off 16: decode and chunk rows both go to fma, which reads q
    byte by byte (stream and mma load 16 bytes at a time)."""
    x, q, scale = _qmm_operands(m, 896, 4864, 128, bits, dtype, offset=1)
    assert q.data_ptr() % 16 == 1 and q.is_contiguous()
    plan = qmm.plan_quant_matmul(m, 896, 4864, 128, bits, dtype,
                                 pa.sm_count(torch.device("cuda")), aligned=False)
    assert plan.schedule == "fma"
    got = qmm.quant_matmul(x, q, scale, bits=bits)
    assert qmm.quant_matmul.last_plan == plan
    want = qmm.quant_matmul_torch(x, q, scale, bits=bits)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)
    torch.testing.assert_close(qmm.quant_matmul(x, q, scale, bits=bits), got, rtol=0, atol=0)


# (batch, hq, hkv, d, ps, C, max_pages, cursors): cursor 0, exactly one page,
# tiles that cross pages of different scales (page 4 and 16 under 64-key
# tiles), C 5, 128 (the serve shape) and 256, at every head dim
CHUNK_MMA_CASES = [(2, 4, 2, 16, 4, 5, 12, (0, 4)), (2, 6, 2, 32, 16, 128, 6, (16, 70)),
                   (1, 14, 2, 64, 16, 128, 24, (256,)), (2, 14, 2, 64, 16, 256, 40, (0, 300)),
                   (2, 8, 2, 128, 16, 40, 8, (16, 100)), (2, 10, 1, 256, 16, 37, 8, (0, 90)),
                   (2, 14, 2, 64, 8, 130, 20, (8, 123))]


def _chunk_mma_operands(case, pool, dtype, offset=0):
    b, hq, hkv, d, ps, c, max_pages, cursors = case
    q, ck, cv, kp, vp, bt, cur = _chunk_inputs(b, hq, hkv, d, ps, c, max_pages, cursors,
                                               dtype=dtype)
    if pool == "dense":
        pools, kw = (kp, vp), {}
        kern, plain = pa.paged_flash_prefill_chunk, pa.paged_prefill_chunk_torch
    else:
        bits = int(pool[3:])
        pools, kw = (*_quantize_pool(kp, bits), *_quantize_pool(vp, bits)), {"bits": bits}
        kern, plain = pa.paged_flash_prefill_chunk_quant, pa.paged_prefill_chunk_quant_torch
    if offset:  # every pool one element off its 16-byte boundary
        shifted = []
        for t in pools:
            if t.dim() == 4:
                flat = torch.empty(t.numel() + 16, dtype=t.dtype, device="cuda")
                t2 = flat[offset:offset + t.numel()].view(t.shape)
                t2.copy_(t)
                t = t2
            shifted.append(t)
        pools = tuple(shifted)
    return kern, plain, (q, ck, cv, *pools, bt, cur), kw


@pytest.mark.parametrize("case", CHUNK_MMA_CASES, ids=_ids(CHUNK_MMA_CASES))
@pytest.mark.parametrize("pool", ["dense", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_chunk_body_matches_plain_at_every_head_dim_and_repeats(case, pool, dtype):
    kern, plain, args, kw = _chunk_mma_operands(case, pool, dtype)
    n = kern.launches
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == n + 1 and got.dtype == dtype
    _assert_kernel_close(got, plain(*args, **kw), dtype)
    torch.testing.assert_close(kern(*args, **kw), got, rtol=0, atol=0)


@pytest.mark.parametrize("pool", ["dense", "int8", "int4"])
def test_chunk_body_takes_misaligned_pools(pool):
    """Pools one element off 16 bytes: the bf16 body stages with plain
    loads; the result is the aligned call's, bit for bit."""
    case = CHUNK_MMA_CASES[2]
    kern, plain, args, kw = _chunk_mma_operands(case, pool, torch.bfloat16, offset=1)
    assert args[3].data_ptr() % 16 != 0
    got = kern(*args, **kw)
    _assert_kernel_close(got, plain(*args, **kw), torch.bfloat16)
    kern2, _, args2, _ = _chunk_mma_operands(case, pool, torch.bfloat16)
    torch.testing.assert_close(kern2(*args2, **kw), got, rtol=0, atol=0)


@pytest.mark.parametrize("pool", ["dense", "int8", "int4"])
def test_chunk_body_matches_its_tiled_twin(pool):
    """The bf16 body against paged_prefill_chunk_tiled_torch (its tiles and
    scale folding in f32) at the serve shape."""
    kern, _, args, kw = _chunk_mma_operands(CHUNK_MMA_CASES[2], pool, torch.bfloat16)
    q, ck, cv, *pools, bt, cur = args
    if pool == "dense":
        want = pa.paged_prefill_chunk_tiled_torch(q, ck, cv, *pools, bt, cur)
    else:
        kq, ks, vq, vs = pools
        want = pa.paged_prefill_chunk_tiled_torch(q, ck, cv, kq, vq, bt, cur, k_scale=ks,
                                                  v_scale=vs, bits=kw["bits"])
    _assert_kernel_close(kern(*args, **kw), want, torch.bfloat16)


def test_planners_assume_the_kernels_geometry():
    """The tile and warp constants quant_matmul's and the chunk body's
    planners use, ssd_scan's chunk and slice (its workspace and grid),
    rglru_scan's columns, steps, stages and threads, and the stencil's tile,
    rows, run and ring (paper_suite's stencil keys), and Sum3D's threads,
    vector bytes and vectors in flight, are the ones the libraries were built
    with (checked when a library loads; a disagreement raises)."""
    from repro_torch.kernels import rglru_scan as rs
    from repro_torch.kernels import ssd_scan as ss

    assert {"stencil_tile_j", "stencil_tile_k", "stencil_rows", "stencil_run",
            "stencil_planes", "stencil_threads"} <= set(paper_suite.GEOMETRY)
    assert {"sum3d_threads", "sum3d_vector_bytes", "sum3d_vectors"} <= set(paper_suite.GEOMETRY)
    for binding, geometry in ((qmm._LIB, qmm.GEOMETRY), (pa._LIB, pa.GEOMETRY),
                              (paper_suite.LIB, paper_suite.GEOMETRY), (ss._LIB, ss.GEOMETRY),
                              (rs._LIB, rs.GEOMETRY)):
        _build.check_geometry(binding.name, binding.lib(), geometry)


def test_chunk_body_splits_its_tiles_where_blocks_are_few():
    """The serve shape (one sequence, C 128, G 7) has 28 blocks of 64 rows:
    the bf16 body cuts their tiles into runs merged by the combine, and
    matches the plain version and the tiled twin in one run and in the
    kernel's own runs; f32 takes one."""
    case = CHUNK_MMA_CASES[2]
    b, hq, hkv, d, ps, c, max_pages, _ = case
    sms = pa.sm_count(torch.device("cuda"))
    splits = pa.plan_chunk_splits(b, hq, hkv, c, d, max_pages, ps, torch.bfloat16, sms)
    assert splits > 1
    assert pa.plan_chunk_splits(b, hq, hkv, c, d, max_pages, ps, torch.float32, sms) == 1
    kern, plain, args, kw = _chunk_mma_operands(case, "dense", torch.bfloat16)
    got = kern(*args, **kw)
    _assert_kernel_close(got, plain(*args, **kw), torch.bfloat16)
    q, ck, cv, kp, vp, bt, cur = args
    for runs in (1, splits):
        want = pa.paged_prefill_chunk_tiled_torch(q, ck, cv, kp, vp, bt, cur, splits=runs)
        _assert_kernel_close(got, want, torch.bfloat16)


# ---------------------------------------------------------------------------------
# the speculative verify window (the chunk kernels at C = K + 1, cursors at any
# alignment) and the fused K-step / S-window dispatches
# ---------------------------------------------------------------------------------
VERIFY_CURSORS = (37, 130, 255, 16, 0, 1, 47, 48)  # mid-page and page-aligned, B 8


@pytest.mark.parametrize("c", [2, 5])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_chunk_kernel_at_the_verify_shape(c, dtype):
    args = _chunk_inputs(8, 14, 2, 64, 16, c, 20, VERIFY_CURSORS, dtype=dtype)
    n = pa.paged_flash_prefill_chunk.launches
    got = pa.paged_flash_prefill_chunk(*args)
    torch.cuda.synchronize()
    assert pa.paged_flash_prefill_chunk.launches == n + 1
    want = pa.paged_prefill_chunk_torch(*args)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("c", [2, 5])
@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("dtype", DTYPES, ids=DT_IDS)
def test_chunk_quant_kernel_at_the_verify_shape(c, bits, dtype):
    q, ck, cv, kp, vp, bt, cur = _chunk_inputs(8, 14, 2, 64, 16, c, 20, VERIFY_CURSORS,
                                               dtype=dtype)
    args = (q, ck, cv, *_quantize_pool(kp, bits), *_quantize_pool(vp, bits), bt, cur)
    got = pa.paged_flash_prefill_chunk_quant(*args, bits=bits)
    torch.cuda.synchronize()
    want = pa.paged_prefill_chunk_quant_torch(*args, bits=bits)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)


def _tree(fn, tree):
    """``fn`` on every tensor of a nested dict / list."""
    if isinstance(tree, dict):
        return {k: _tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree(fn, v) for v in tree]
    return fn(tree)


def _smoke_serving_state(kv_dtype="f32", batch=4, ps=4, max_pages=12):
    """The smoke model on the card with seeded weights, its page pools, and
    decode state for ``batch`` rows at lengths mid-page and on boundaries."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving.engine import KV_DTYPES

    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cuda")
    params = model.init_params(torch.Generator(device="cuda").manual_seed(0))
    spec = KV_DTYPES[kv_dtype]
    num_pages = batch * max_pages + 1
    caches = model.init_paged_cache(num_pages, ps, kv_spec=spec)
    rng = np.random.default_rng(1)
    bt = torch.from_numpy(rng.permutation(np.arange(1, num_pages)).reshape(
        batch, max_pages).astype(np.int32)).cuda()
    lens = torch.tensor([5, 8, 13, 3][:batch], dtype=torch.int32, device="cuda")
    toks = torch.tensor(rng.integers(0, cfg.vocab, size=batch), dtype=torch.int32,
                        device="cuda")
    slot_f32 = torch.tensor([[0.0, 0.9, 0.0, 0.8], [1.0, 0.95, 1.0, 1.0]],
                            device="cuda")[:, :batch].contiguous()
    slot_i32 = torch.tensor([[1, 1, 0, 1], [0, 20, 0, 5], [7, 8, 9, 10]], dtype=torch.int32,
                            device="cuda")[:, :batch].contiguous()
    return cfg, model, params, spec, caches, bt, lens, toks, slot_f32, slot_i32


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_fused_multistep_window_makes_no_host_sync(kv_dtype):
    """K = 4 fused steps, greedy and sampled, with the top-k pair: under
    set_sync_debug_mode("error") any device-to-host transfer inside the
    window raises; the window's tokens equal K single steps'."""
    from repro_torch.serving.step import make_paged_serve_multistep, make_paged_serve_step

    cfg, model, params, spec, caches, bt, lens, toks, f32, i32 = _smoke_serving_state(kv_dtype)
    multi = make_paged_serve_multistep(model, 4, spec, logprobs_k=3)
    single = make_paged_serve_step(model, spec)
    for sampled in (False, True):
        fresh, other = _tree(torch.clone, caches), _tree(torch.clone, caches)
        n = pa.paged_flash_decode.launches + pa.paged_flash_decode_quant.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = multi(params, fresh, toks, bt, lens, f32, i32, sampled=sampled)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        launched = pa.paged_flash_decode.launches + pa.paged_flash_decode_quant.launches - n
        assert launched == 4 * cfg.n_layers
        t, l = toks, lens
        for k in range(4):
            nxt, _, l, _, _ = single(params, other, t, bt, l, f32, i32, sampled=sampled)
            assert torch.equal(nxt, out[0][k]), (sampled, k)
            t = nxt
        assert torch.equal(l, out[2])
        assert out[5][0].shape == (4, 4, 3)


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_speculative_windows_make_no_host_sync(kv_dtype):
    """S = 2 speculative windows at K = 4 (the verify on the chunk kernel at
    C 5, cursors mid-page): no device-to-host transfer inside the dispatch."""
    from repro_torch.serving.speculative import NGramProposer, make_paged_serve_spec_multistep

    cfg, model, params, spec, caches, bt, lens, toks, f32, i32 = _smoke_serving_state(kv_dtype)
    prop = NGramProposer(spec_tokens=4, ngram=2, table_size=64, vocab=cfg.vocab, hist_len=60)
    step = make_paged_serve_spec_multistep(model, 2, prop, spec, logprobs_k=2)
    rows = [prop.rebuild_row([3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 9, 7, 9][:int(n) + 1])
            for n in lens.tolist()]
    hist = torch.from_numpy(np.stack([h for h, _ in rows])).cuda()
    table = torch.from_numpy(np.stack([t for _, t in rows])).cuda()
    chunk = pa.paged_flash_prefill_chunk if spec is None else pa.paged_flash_prefill_chunk_quant
    for sampled in (False, True):
        n = chunk.launches
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = step(params, caches, toks, bt, lens, f32, i32, hist, table, sampled=sampled)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert chunk.launches - n == 2 * cfg.n_layers
        committed = out[1].cpu()
        assert committed.shape == (2, 4) and (committed[:, 2] == 0).all()
        assert ((committed[:, [0, 1, 3]] >= 1) & (committed[:, [0, 1, 3]] <= 5)).all()


@pytest.mark.parametrize("kv_dtype", ["f32", "int8"])
def test_spec_and_fused_engines_on_cuda_match_the_plain_engine_on_cpu(kv_dtype):
    """Greedy tokens of the speculative (K 4, S 2) and fused (K 4) engines on
    the card equal the plain engine's on the CPU; the verify ran the chunk
    kernel."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import EngineConfig, Request, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    params_cpu = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    params_gpu = _tree(lambda t: t.cuda(), params_cpu)
    rng = np.random.default_rng(10)
    prompts = [(rng.integers(0, cfg.vocab, size=4).tolist() * 3)[:10] for _ in range(3)]
    base = dict(num_pages=64, page_size=4, max_batch=3, max_pages_per_seq=12, kv_dtype=kv_dtype)
    mk = lambda: [Request(i, p, GenerationParams(max_new_tokens=16))
                  for i, p in enumerate(prompts)]
    want = ServeEngine(cpu, params_cpu, EngineConfig(**base), device="cpu").run(mk())
    chunk = "paged_prefill_chunk" + ("_quant" if kv_dtype != "f32" else "")
    for extra in (dict(spec_tokens=4, multi_step=2, spec_backoff=0), dict(multi_step=4)):
        kernels.reset_launch_counts()
        eng = ServeEngine(gpu, params_gpu, EngineConfig(**base, **extra), device="cuda")
        got = eng.run(mk())
        counts = kernels.launch_counts()
        for i in range(len(prompts)):
            assert got[i].generated == want[i].generated, (extra, i)
        if "spec_tokens" in extra:
            assert eng.metrics()["spec_windows"] > 0 and counts[chunk] > 0
        else:
            assert eng.metrics()["fused_steps"] > 0


# ---------------------------------------------------------------------------------
# parallel generation, constrained decoding and the host tier on the card
# ---------------------------------------------------------------------------------
def _aliased_tables(max_pages, ps, num_pages, seed=0):
    """Block tables as best-of-n forks and beam reorders leave them, B 8: row
    0 owns its pages (a partial last page); rows 1-3 are forks of row 0 (a
    leading run of its pages, then one private last page each, different
    lengths); rows 4-7 take rows 0-3's tables and lengths in a permuted
    order (beam reorders rebind whole rows)."""
    rng = np.random.default_rng(seed)
    pool = rng.permutation(np.arange(1, num_pages))
    n0 = max_pages - 2
    tables = np.zeros((8, max_pages), np.int32)
    lens = np.zeros((8,), np.int32)
    tables[0, :n0] = pool[:n0]
    lens[0] = (n0 - 1) * ps + 5
    for r, m in zip((1, 2, 3), (n0 - 1, n0 // 2, 1)):
        tables[r, :m] = pool[:m]
        tables[r, m] = pool[n0 + r]
        lens[r] = m * ps + 1 + 3 * r
    perm = [2, 0, 3, 1]
    tables[4:], lens[4:] = tables[perm], lens[perm]
    return torch.from_numpy(tables).cuda(), torch.from_numpy(lens).cuda()


@pytest.mark.parametrize("kv", ["dense", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("max_pages,ps,d", [(32, 16, 64), (128, 16, 64), (12, 4, 16)])
def test_decode_over_aliased_and_permuted_tables_matches_plain(max_pages, ps, d, dtype, kv):
    """The split-K paged decode where rows share pages (forks) and repeat
    other rows' tables (beam reorders): each row equals the plain version,
    and rows that read the same table with the same query are bit-equal."""
    g = torch.Generator(device="cuda").manual_seed(5)
    num_pages = 8 * max_pages + 1
    bt, lens = _aliased_tables(max_pages, ps, num_pages)
    kp = torch.randn(num_pages, 2, ps, d, generator=g, device="cuda").to(dtype)
    vp = torch.randn(num_pages, 2, ps, d, generator=g, device="cuda").to(dtype)
    q = torch.randn(8, 14, 1, d, generator=g, device="cuda").to(dtype)
    q[4:] = q[[2, 0, 3, 1]]  # a reordered row reads its parent's query too
    if kv == "dense":
        got = pa.paged_flash_decode(q, kp, vp, bt, lens)
        torch.cuda.synchronize()
        want = pa.paged_decode_attention_torch(q, kp, vp, bt, lens)
    else:
        bits = int(kv[3:])
        args = (q, *_quantize_pool(kp, bits), *_quantize_pool(vp, bits), bt, lens)
        got = pa.paged_flash_decode_quant(*args, bits=bits)
        torch.cuda.synchronize()
        want = pa.paged_decode_attention_quant_torch(*args, bits=bits)
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)
    assert torch.equal(got[4:], got[[2, 0, 3, 1]])


def _grammar_tables(vocab, device):
    from repro_torch.serving.grammar import JSON_ARRAY_CHARS, fixed_json_array_dfa

    charmap = {ch: i for i, ch in enumerate(JSON_ARRAY_CHARS)}
    dfa = fixed_json_array_dfa(charmap, len(JSON_ARRAY_CHARS), vocab, n_items=3)
    n = dfa.n_states
    gmask = np.zeros((1 + n, vocab), np.float32)
    gtrans = np.zeros((1 + n, vocab), np.int32)
    gmask[1:] = dfa.mask
    gtrans[1:] = dfa.next_state + 1
    return dfa, torch.from_numpy(gmask).to(device), torch.from_numpy(gtrans).to(device)


@pytest.mark.parametrize("kv_dtype", ["f32", "int4"])
def test_grammar_multistep_window_makes_no_host_sync(kv_dtype):
    """K = 4 fused steps with the grammar stage (three rows constrained, one
    unconstrained): no device-to-host transfer inside the window; the tokens
    equal K single steps', and every constrained token is allowed by the
    state it left."""
    from repro_torch.serving.step import make_paged_serve_multistep, make_paged_serve_step

    cfg, model, params, spec, caches, bt, lens, toks, f32, i32 = _smoke_serving_state(kv_dtype)
    dfa, gmask, gtrans = _grammar_tables(cfg.vocab, "cuda")
    multi = make_paged_serve_multistep(model, 4, spec, logprobs_k=2, grammar=True)
    single = make_paged_serve_step(model, spec, grammar=True)
    gstate0 = torch.tensor([1, 0, 3, 2], dtype=torch.int32, device="cuda")
    for sampled in (False, True):
        fresh, other = _tree(torch.clone, caches), _tree(torch.clone, caches)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = multi(params, fresh, toks, bt, lens, f32, i32, gstate0, gmask, gtrans,
                        sampled=sampled)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        t, l, gs = toks, lens, gstate0
        for k in range(4):
            nxt, _, l, _, _, gs = single(params, other, t, bt, l, f32, i32, gs, gmask, gtrans,
                                         sampled=sampled)
            assert torch.equal(nxt, out[0][k]), (sampled, k)
            t = nxt
        assert torch.equal(gs, out[5])
        walk = out[0].cpu().numpy()
        active = i32[0].cpu().numpy()
        for b in range(4):
            s = int(gstate0[b]) - 1
            if s < 0 or not active[b]:
                continue
            for tok in walk[:, b]:
                assert dfa.allows(s, int(tok)), (b, s, tok)
                s = dfa.step(s, int(tok))


def test_best_of_n_dispatch_over_forked_rows_makes_no_host_sync():
    """A sampled decode step where rows 1-3 fork row 0 (its pages, then a
    private last page), each on its branch seed: no device-to-host transfer,
    and each row's token equals the same step over private copies of the
    shared pages (the kernel reads aliased rows as it reads unique ones)."""
    from repro_torch.serving.step import make_paged_serve_step

    cfg, model, params, spec, caches, bt, lens, toks, f32, i32 = _smoke_serving_state("f32")
    for leaf in _tree(lambda t: t, caches)[0].values():
        leaf.normal_(generator=torch.Generator(device="cuda").manual_seed(3))
    fork = bt.clone()
    fork[1:, :2] = bt[0, :2]  # two shared full pages, then each row's own
    blen = torch.full_like(lens, 10)
    toks = torch.full_like(toks, 7)
    f32 = torch.tensor([[0.8] * 4, [1.0] * 4], device="cuda")
    i32 = torch.tensor([[1] * 4, [8] * 4, [11, 12, 13, 14]], dtype=torch.int32, device="cuda")
    step = make_paged_serve_step(model, spec, logprobs_k=3)
    aliased = _tree(torch.clone, caches)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = step(params, aliased, toks, fork, blen, f32, i32, sampled=True)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    private = _tree(torch.clone, caches)
    for leaf in private[0].values():
        for r in range(1, 4):
            leaf[:, bt[r, :2].long()] = leaf[:, bt[0, :2].long()]
    want = step(params, private, toks, bt, blen, f32, i32, sampled=True)
    assert torch.equal(out[0], want[0])
    assert torch.equal(out[4], want[4])


def test_int4_pages_demote_and_promote_on_the_card_byte_equal():
    from repro_torch.models import build_model, get_config
    from repro_torch.serving.engine import PagedKVCache
    from repro_torch.serving.engine.kvquant import pool_leaves
    from repro_torch.serving.engine.request import page_hash_chain

    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    model = build_model(cfg, device="cuda")
    cache = PagedKVCache(model, num_pages=16, page_size=4, max_batch=2, max_pages_per_seq=6,
                         kv_dtype="int4", host_pool_pages=8)
    tokens = list(range(40, 52))
    chain = page_hash_chain(tokens, 4)
    pages = cache.allocate(0, 4, tokens=tokens, chain=chain)
    g = torch.Generator(device="cuda").manual_seed(4)
    for leaf in pool_leaves(cache.pools):
        leaf[:, pages] = torch.randint(0, 100, leaf[:, pages].shape, generator=g,
                                       device="cuda").to(leaf.dtype)
    snap = [leaf[:, pages[:3]].clone() for leaf in pool_leaves(cache.pools)]
    cache.set_len(0, 12)
    assert cache.demote_slot(0, chain) == 3
    cache.free_slot(0)
    for leaf in pool_leaves(cache.pools):
        leaf[:, pages[:3]] = 0
    new = cache.allocate(1, 4, tokens=tokens, chain=chain)
    assert cache.tier.prefetch_hits == 3
    assert all(t.device.type == "cpu" for t in cache.tier._leaves)
    for leaf, want in zip(pool_leaves(cache.pools), snap):
        assert torch.equal(leaf[:, new[:3]], want)
    cache.free_slot(1)
    cache.check_conservation()


def test_branch_grammar_and_tier_engines_on_cuda_match_the_cpu_engine():
    """Best-of-n, beam, a grammar and a tight pool with a host tier over
    int4 pages, on the card: the same tokens, scores and counters as the
    same engines on the CPU."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import GenerationParams
    from repro_torch.serving.engine import EngineConfig, ServeEngine

    cfg = dataclasses.replace(get_config("qwen2-0.5b", smoke=True), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    params_cpu = cpu.init_params(torch.Generator().manual_seed(0))
    gpu = build_model(cfg, device="cuda")
    params_gpu = _tree(lambda t: t.cuda(), params_cpu)
    dfa, _, _ = _grammar_tables(cfg.vocab, "cpu")
    rng = np.random.default_rng(6)
    p = [rng.integers(0, cfg.vocab, size=n).tolist() for n in (7, 8, 6, 9)]
    eos = len("[],0123456789")
    cases = {
        "best_of_n": (dict(), [(p[0], dict(max_new_tokens=8, temperature=0.8, top_k=8, seed=3,
                                          n=4))]),
        "beam": (dict(max_beam_width=4), [(p[1], dict(max_new_tokens=6, beam_width=4, n=2))]),
        "grammar": (dict(grammar_states=dfa.n_states, multi_step=4),
                    [(q, dict(max_new_tokens=12, temperature=0.9, seed=i, eos_id=eos,
                              grammar=dfa)) for i, q in enumerate(p)]),
        "tier": (dict(num_pages=9, max_batch=3, max_pages_per_seq=6, host_pool_pages=32,
                      kv_dtype="int4"), [(q, dict(max_new_tokens=10)) for q in p[:3]]),
    }
    keys = ("branch_forks", "beam_reorders", "cow_copies", "preemptions", "swap_out_pages",
            "swap_in_pages", "prefetch_hits")
    for name, (extra, jobs) in cases.items():
        conf = EngineConfig(**{**dict(num_pages=64, page_size=4, max_batch=8,
                                      max_pages_per_seq=8), **extra})
        seqs, metrics = [], []
        for model, params, dev in ((cpu, params_cpu, "cpu"), (gpu, params_gpu, "cuda")):
            eng = ServeEngine(model, params, conf, device=dev)
            hs = [eng.submit(q, GenerationParams(**g), rid=i) for i, (q, g) in enumerate(jobs)]
            eng.run()
            seqs.append([[(s.tokens, s.cumulative_logprob) for s in h.sequences] for h in hs])
            metrics.append(eng.metrics())
        for a, b in zip(*seqs):
            assert [t for t, _ in a] == [t for t, _ in b], name
            np.testing.assert_allclose([c for _, c in a], [c for _, c in b], atol=1e-4, rtol=0)
        for k in keys:
            assert metrics[0].get(k) == metrics[1].get(k), (name, k)


# ---------------------------------------------------------------------------------
# head dim 128 at the dense configs' groups (qwen2.5-3b: Hq 16 / Hkv 2, group 8;
# granite-8b: Hq 32 / Hkv 8, group 4) and the autotuner's page sizes 8 and 32
# ---------------------------------------------------------------------------------
_D128_LENS = (0, 1, 9, 100, 517, 1024, 1500, 2048)
_D128_CURSORS = (37, 130, 255, 16, 0, 8, 512, 1000)
# (batch, page_size, lens, hq, hkv, d)
D128_DECODE_CASES = [
    (8, 8, _D128_LENS, 16, 2, 128), (8, 32, _D128_LENS, 16, 2, 128),
    (8, 8, _D128_LENS, 32, 8, 128), (8, 32, _D128_LENS, 32, 8, 128),
]
# (batch, hq, hkv, d, ps, C, max_pages, cursors): a 128-token chunk and the
# verify window C 5
D128_CHUNK_CASES = [
    (2, 16, 2, 128, 8, 128, 160, (0, 1024)), (2, 32, 8, 128, 32, 128, 40, (0, 1024)),
    (8, 16, 2, 128, 32, 5, 40, _D128_CURSORS), (8, 32, 8, 128, 8, 5, 160, _D128_CURSORS),
]


def _pools(args, pool_idx, pools):
    """The inputs with the K/V pools at ``pool_idx`` dense, or int8 / int4
    encoded (-> (args, bits or None))."""
    if pools == "dense":
        return args, None
    bits = int(pools[3:])
    i = pool_idx
    return (*args[:i], *_quantize_pool(args[i], bits), *_quantize_pool(args[i + 1], bits),
            *args[i + 2:]), bits


def _check(got, want, dtype):
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, **TOL)
    else:
        assert _within_one_bf16_ulp(got, want)


@pytest.mark.parametrize("case", D128_DECODE_CASES, ids=_ids(D128_DECODE_CASES))
@pytest.mark.parametrize("pools", ["dense", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_d128_decode_matches_plain(case, pools, dtype):
    args, bits = _pools(_decode_inputs(*case, dtype=dtype), 1, pools)
    if bits is None:
        got, want = pa.paged_flash_decode(*args), pa.paged_decode_attention_torch(*args)
    else:
        got = pa.paged_flash_decode_quant(*args, bits=bits)
        want = pa.paged_decode_attention_quant_torch(*args, bits=bits)
    torch.cuda.synchronize()
    _check(got, want, dtype)
    assert torch.count_nonzero(got[0]) == 0  # the length-0 row


@pytest.mark.parametrize("case", D128_CHUNK_CASES, ids=_ids(D128_CHUNK_CASES))
@pytest.mark.parametrize("pools", ["dense", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_d128_chunk_matches_plain(case, pools, dtype):
    args, bits = _pools(_chunk_inputs(*case, dtype=dtype), 3, pools)
    if bits is None:
        got = pa.paged_flash_prefill_chunk(*args)
        want = pa.paged_prefill_chunk_torch(*args)
    else:
        got = pa.paged_flash_prefill_chunk_quant(*args, bits=bits)
        want = pa.paged_prefill_chunk_quant_torch(*args, bits=bits)
    torch.cuda.synchronize()
    _check(got, want, dtype)


@pytest.mark.parametrize("arch,kv_dtype", [("qwen2.5-3b", "f32"), ("granite-8b", "int8")])
def test_autotune_cold_sweep_then_warm_resolve(tmp_path, arch, kv_dtype):
    """A cold resolve on the card sweeps page sizes 8 / 16 / 32 at block_pages
    1 only (the CUDA decode ignores the knob) and chunk widths at the winner,
    launching the decode and chunk kernels; a warm one reads the table and
    launches nothing."""
    from repro_torch.kernels import autotune
    from repro_torch.models import get_config

    cfg = get_config(arch)
    path = tmp_path / "tune.json"
    decode = "paged_decode" if kv_dtype == "f32" else "paged_decode_quant"
    chunk = "paged_prefill_chunk" if kv_dtype == "f32" else "paged_prefill_chunk_quant"
    kernels.reset_launch_counts()
    cold = autotune.resolve(cfg, kv_dtype=kv_dtype, batch=8, seq_len=544, cache_path=path,
                            device="cuda")
    launched = kernels.launch_counts()
    per = autotune._SWEEP_WARMUP + autotune._SWEEP_REPS
    assert launched[decode] == len(autotune.PAGE_SIZE_CANDIDATES) * per
    assert launched[chunk] == len(autotune.CHUNK_PAGE_MULTIPLIERS) * per
    assert cold.source == "swept" and cold.block_pages == 1 and cold.us_per_step > 0
    assert cold.page_size in autotune.PAGE_SIZE_CANDIDATES
    assert cold.chunk_tokens % cold.page_size == 0
    kernels.reset_launch_counts()
    warm = autotune.resolve(cfg, kv_dtype=kv_dtype, batch=8, seq_len=544, cache_path=path,
                            device="cuda")
    assert not any(kernels.launch_counts().values())
    assert warm == dataclasses.replace(cold, source="cached")


# ---------------------------------------------------------------------------------
# head dim 112 (kimi-k2: Hq 64, Hkv 8, group 8): the split-K decode's 14
# feature lanes in a 16-lane group, the tensor-core tile's 7 k-steps and 14
# column groups, int4 rows of 56 bytes
# ---------------------------------------------------------------------------------
D112_DECODE_CASES = [
    (8, 16, _D128_LENS, 64, 8, 112), (8, 8, _D128_LENS, 64, 8, 112),
    (3, 16, (0, 33, 700), 16, 2, 112),
]
D112_CHUNK_CASES = [
    (1, 64, 8, 112, 16, 128, 160, (256,)), (2, 64, 8, 112, 16, 128, 40, (0, 300)),
    (8, 64, 8, 112, 16, 5, 160, _D128_CURSORS), (2, 16, 2, 112, 16, 37, 8, (0, 90)),
]


@pytest.mark.parametrize("case", D112_DECODE_CASES, ids=_ids(D112_DECODE_CASES))
@pytest.mark.parametrize("pools", ["dense", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_d112_decode_matches_plain(case, pools, dtype):
    test_d128_decode_matches_plain(case, pools, dtype)


@pytest.mark.parametrize("case", D112_CHUNK_CASES, ids=_ids(D112_CHUNK_CASES))
@pytest.mark.parametrize("pools", ["dense", "int8", "int4"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_d112_chunk_matches_plain_and_repeats(case, pools, dtype):
    kern, plain, args, kw = _chunk_mma_operands(case, pools, dtype)
    n = kern.launches
    got = kern(*args, **kw)
    torch.cuda.synchronize()
    assert kern.launches == n + 1
    _assert_kernel_close(got, plain(*args, **kw), dtype)
    torch.testing.assert_close(kern(*args, **kw), got, rtol=0, atol=0)


@pytest.mark.parametrize("pool", ["dense", "int8", "int4"])
def test_d112_chunk_takes_misaligned_pools(pool):
    case = D112_CHUNK_CASES[0]
    kern, plain, args, kw = _chunk_mma_operands(case, pool, torch.bfloat16, offset=1)
    assert args[3].data_ptr() % 16 != 0
    got = kern(*args, **kw)
    _assert_kernel_close(got, plain(*args, **kw), torch.bfloat16)
    kern2, _, args2, _ = _chunk_mma_operands(case, pool, torch.bfloat16)
    torch.testing.assert_close(kern2(*args2, **kw), got, rtol=0, atol=0)


@pytest.mark.parametrize("mask", FLASH_MASKS, ids=["causal", "window24", "full"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_d112_flash_attention_matches_plain(mask, dtype):
    for case in ((2, 64, 8, 512, 512, 112), (1, 16, 2, 45, 45, 112)):
        test_flash_attention_kernel_matches_plain(case, mask, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_d112_flash_decode_matches_plain(dtype):
    from repro_torch.kernels import flash_attention as fa

    q = _rand((8, 64, 1, 112), dtype, 51)
    kc, vc = _rand((8, 8, 512, 112), dtype, 52), _rand((8, 8, 512, 112), dtype, 53)
    for pos in (0, 31, 32, 300, 511):
        for window in (None, 24):
            got = fa.flash_decode(q, kc, vc, torch.tensor([pos], dtype=torch.int32,
                                                          device="cuda"), window=window)
            _assert_kernel_close(got, fa.decode_attention_torch(q, kc, vc, pos, window=window),
                                 dtype)


# ---------------------------------------------------------------------------------
# cross-attention (whisper-large-v3: 20 / 20 heads of 64 over 1500 frames;
# llama-3.2-vision: 64 / 8 heads of 128 over 6404 image tokens): flash_attention
# non-causal at Tq != Tk, the key tails 1500 % 64 = 28 and 6404 % 64 = 4 and
# smaller ones, and the cross decode, flash_decode at pos Tc - 1 (every slot
# live, so non-causal attention at Tq 1); whisper-smoke and vision-smoke
# served on the card against the CPU
# ---------------------------------------------------------------------------------
CROSS_FLASH_CASES = [(1, 20, 20, 1500, 1500, 64), (4, 20, 20, 64, 1500, 64),
                     (2, 64, 8, 128, 6404, 128), (1, 4, 1, 5, 131, 64), (2, 8, 2, 1, 77, 128),
                     (1, 4, 4, 70, 12, 64)]
CROSS_DECODE_CASES = [(4, 20, 20, 1500, 64), (2, 64, 8, 6404, 128), (1, 4, 1, 131, 64),
                      (3, 8, 8, 12, 64)]


@pytest.mark.parametrize("case", CROSS_FLASH_CASES, ids=_ids(CROSS_FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cross_flash_attention_matches_plain(case, dtype):
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, tq, tk, d = case
    q, k, v = _rand((b, hq, tq, d), dtype, 61), _rand((b, hkv, tk, d), dtype, 62), \
        _rand((b, hkv, tk, d), dtype, 63)
    n = fa.flash_attention.launches
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert fa.flash_attention.launches == n + 1
    _assert_kernel_close(got, fa.attention_torch(q, k, v, causal=False), dtype)


@pytest.mark.parametrize("case", CROSS_DECODE_CASES, ids=_ids(CROSS_DECODE_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_cross_decode_matches_plain(case, dtype):
    """ops.decode_attention at pos Tc - 1 launches flash_decode and equals
    both plain forms: the decode at Tc - 1 and non-causal attention."""
    from repro_torch.kernels import flash_attention as fa

    b, hq, hkv, tc, d = case
    q = _rand((b, hq, 1, d), dtype, 64)
    kc, vc = _rand((b, hkv, tc, d), dtype, 65), _rand((b, hkv, tc, d), dtype, 66)
    n = fa.flash_decode.launches
    got = ops.decode_attention(q, kc, vc, tc - 1)
    torch.cuda.synchronize()
    assert fa.flash_decode.launches == n + 1
    _assert_kernel_close(got, fa.decode_attention_torch(q, kc, vc, tc - 1), dtype)
    _assert_kernel_close(got, fa.attention_torch(q, kc, vc, causal=False), dtype)


@pytest.mark.parametrize("arch", ["whisper-large-v3", "llama-3.2-vision-90b"])
def test_cross_serve_on_cuda_matches_cpu(arch):
    """make_prefill(batch_inputs=) + make_serve_step on the smoke config in
    f32, the same weights (every vision gate at 0.7: at the init's 0 the cross
    layer is erased; the attention projections rescaled to their fan-in: at
    the reference's init whisper-smoke's logits drift 8.5e-4 between card and
    CPU) and inputs on the card and on the CPU: logits within 1e-4 a step, 8
    greedy tokens equal, flash_attention and flash_decode launched on the
    card."""
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import make_prefill, make_serve_step

    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
    out = {}
    for device in ("cuda", "cpu"):
        model = build_model(cfg, device=device)
        params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
        params = _tree_to(params, device)
        for p in params["blocks"][0]:
            if "gate" in p:
                p["gate"].fill_(0.7)
        _condition_attention(cfg, params)
        rng = np.random.default_rng(0)
        toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 9))).to(device)
        n_ctx = cfg.enc_seq if cfg.family == "encdec" else cfg.n_img_tokens
        key = "frames" if cfg.family == "encdec" else "image_embeds"
        ctx = torch.from_numpy(rng.standard_normal((2, n_ctx, cfg.d_model), np.float32))
        kernels.reset_launch_counts()
        logits, caches = make_prefill(model, max_len=17)(params, toks,
                                                         batch_inputs={key: ctx.to(device)})
        step = make_serve_step(model)
        rows, nxt = [logits[:, -1]], torch.argmax(logits[:, -1, :cfg.vocab], -1)
        seq = [nxt.tolist()]
        for i in range(7):
            logits, caches = step(params, caches, nxt.to(torch.int32), 9 + i)
            nxt = torch.argmax(logits[:, :cfg.vocab], -1)
            rows.append(logits)
            seq.append(nxt.tolist())
        out[device] = (torch.stack(rows).cpu(), seq, kernels.launch_counts())
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0], rtol=1e-4, atol=1e-4)
    assert out["cuda"][1] == out["cpu"][1]
    assert out["cuda"][2]["flash_attention"] > 0 and out["cuda"][2]["flash_decode"] > 0


def _tree_to(tree, device):
    if isinstance(tree, dict):
        return {k: _tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_to(v, device) for v in tree]
    return tree.to(device)


def _condition_attention(cfg, params):
    """Every attention projection of a parameter tree rescaled in place to
    std 1/sqrt(its fan-in), as chip_smoke.py's condition_attention."""
    if isinstance(params, list):
        for v in params:
            _condition_attention(cfg, v)
    elif isinstance(params, dict):
        if "wq" in params:
            d, hq, hkv = cfg.d_model, cfg.n_heads, cfg.n_kv_heads
            for name, sq in (("wq", hq / d), ("wk", hkv / d), ("wv", hkv / d), ("wo", 1 / hq)):
                params[name].mul_(math.sqrt(sq))
        else:
            for v in params.values():
                _condition_attention(cfg, v)


# ---------------------------------------------------------------------------------
# the flash-attention backward (kernels/flash_vjp.py, csrc/flash_attention_bwd.cu)
# ---------------------------------------------------------------------------------
# (b, hq, hkv, tq, tk, d, causal, window, q_offset): GQA groups 1-4, key tails
# past the 64-key tile (and the 32-key tile at D 256), the causal start tile
# at q_offset > 0, windows, Tq != Tk, every head dim
BWD_CASES = [(2, 4, 2, 37, 37, 16, True, None, 0), (1, 6, 2, 70, 70, 32, True, None, 0),
             (2, 8, 2, 130, 130, 64, True, None, 0), (1, 4, 1, 96, 96, 64, True, 24, 0),
             (2, 4, 4, 20, 150, 64, False, None, 0), (1, 4, 2, 40, 100, 64, True, None, 60),
             (1, 4, 2, 33, 90, 64, True, 16, 57), (1, 8, 8, 65, 65, 112, True, None, 0),
             (2, 4, 2, 129, 129, 128, True, None, 0), (1, 4, 1, 70, 70, 256, True, None, 0),
             (1, 2, 2, 20, 75, 256, False, None, 0)]
BWD_RTOL = 1e-4  # of each gradient's max-abs: sums over Tq (and the group) in another order


def _bwd_inputs(case, dtype, seed=0):
    b, hq, hkv, tq, tk, d = case[:6]
    return (_rand((b, hq, tq, d), dtype, seed), _rand((b, hkv, tk, d), dtype, seed + 1),
            _rand((b, hkv, tk, d), dtype, seed + 2), _rand((b, hq, tq, d), dtype, seed + 3))


def _assert_grad_close(got, want, dtype, what=""):
    """f32: max |got - want| <= 1e-4 * max |want|; bf16: elementwise within one
    bf16 ulp of want plus that f32 bound."""
    assert got.dtype == want.dtype and got.shape == want.shape
    w = want.float()
    tol = BWD_RTOL * float(w.abs().max())
    d = (got.float() - w).abs()
    if dtype == torch.float32:
        assert float(d.max()) <= tol, (what, float(d.max()), tol)
    else:
        _, e = torch.frexp(w)
        ulp = torch.ldexp(torch.ones_like(w), e - 8)
        assert float((d - ulp - tol).max()) <= 0, (what, float(d.max()), tol)


@pytest.mark.parametrize("case", BWD_CASES, ids=_ids(BWD_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_bwd_matches_plain(case, dtype):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_vjp as fv

    causal, window, off = case[6:]
    q, k, v, g = _bwd_inputs(case, dtype)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
    out = fa.flash_attention(q, k, v, causal=causal, window=window, q_offset=off, lse=lse)
    out_p, lse_p = fa.attention_torch(q, k, v, causal=causal, window=window, q_offset=off,
                                      return_lse=True)
    torch.testing.assert_close(lse, lse_p, rtol=2e-5, atol=2e-5)
    n = fv.flash_attention_bwd.launches
    got = fv.flash_attention_bwd(q, k, v, out, g, lse, causal=causal, window=window,
                                 q_offset=torch.tensor(off, device="cuda"))
    torch.cuda.synchronize()
    assert fv.flash_attention_bwd.launches == n + 1
    want = fv.flash_bwd_torch(q, k, v, out, g, lse, causal=causal, window=window, q_offset=off)
    for name, a, b_ in zip(("dq", "dk", "dv"), got, want):
        _assert_grad_close(a, b_, dtype, name)
    again = fv.flash_attention_bwd(q, k, v, out, g, lse, causal=causal, window=window,
                                   q_offset=off)
    for a, b_ in zip(got, again):  # no atomics: the same bits from run to run
        assert torch.equal(a, b_)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_flash_attention_lse_output_leaves_out_bit_equal(dtype):
    from repro_torch.kernels import flash_attention as fa

    q, k, v, _ = _bwd_inputs((2, 8, 2, 100, 160, 64), dtype, seed=4)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device="cuda")
    for kw in (dict(causal=True, q_offset=60), dict(causal=False), dict(window=24)):
        plain = fa.flash_attention(q, k, v, **kw)
        with_lse = fa.flash_attention(q, k, v, lse=lse, **kw)
        assert torch.equal(plain, with_lse), kw
        _, want = fa.attention_torch(q, k, v, return_lse=True, **kw)
        torch.testing.assert_close(lse, want, rtol=2e-5, atol=2e-5)


def test_flash_attention_bwd_fully_masked_rows_are_zero():
    from repro_torch.kernels import flash_vjp as fv

    q, k, v, g = _bwd_inputs((1, 4, 2, 9, 14, 32), torch.float32, seed=6)
    q, k, v = (t.requires_grad_() for t in (q, k, v))
    out = fv.FlashAttentionFn.apply(q, k, v, True, None, -3, None)  # rows 0-2 see no key
    out.backward(g)
    assert torch.count_nonzero(out[:, :, :3]) == 0
    for t in (q.grad, k.grad, v.grad):
        assert torch.isfinite(t).all()
    assert torch.count_nonzero(q.grad[:, :, :3]) == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_ops_attention_gradients_on_the_kernels_match_the_plain_path(dtype):
    grads = {}
    for impl in ("auto", "torch"):
        q, k, v, g = _bwd_inputs((2, 8, 2, 80, 80, 64), dtype, seed=8)
        q, k, v = (t.requires_grad_() for t in (q, k, v))
        ops.attention(q, k, v, causal=True, window=32, impl=impl).backward(g)
        grads[impl] = (q.grad, k.grad, v.grad)
    for name, a, b_ in zip(("dq", "dk", "dv"), grads["auto"], grads["torch"]):
        _assert_grad_close(a, b_, dtype, name)


def test_kernels_without_a_backward_refuse_a_gradient():
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import rglru_scan as trg
    from repro_torch.kernels import ssd_scan as tss

    x = _rand((2, 4, 16, 32), torch.float32, 1).requires_grad_()
    k = _rand((2, 2, 16, 32), torch.float32, 2)
    with pytest.raises(RuntimeError, match="flash_attention"):
        fa.flash_attention(x, k, k)
    with pytest.raises(RuntimeError, match="flash_decode"):
        fa.flash_decode(x[:, :, :1], k, k, 5)
    pool = _rand((5, 2, 8, 32), torch.float32, 3).requires_grad_()
    bt = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32, device="cuda")
    lens = torch.tensor([9, 12], dtype=torch.int32, device="cuda")
    with pytest.raises(RuntimeError, match="paged_decode"):
        pa.paged_flash_decode(x[:, :, :1].detach(), pool, pool, bt, lens)
    with pytest.raises(RuntimeError, match="quant_matmul"):
        qmm.quant_matmul(_rand((4, 64), torch.float32, 4).requires_grad_(),
                         torch.zeros((32, 64), dtype=torch.int8, device="cuda"),
                         torch.ones((32, 1), device="cuda"), bits=8)
    a = torch.rand((2, 16, 64), device="cuda").requires_grad_()
    with pytest.raises(RuntimeError, match="rglru_scan"):
        trg.rglru_scan(a, a)
    with pytest.raises(RuntimeError, match="sum3d"):
        tsum.sum3d(_rand((8, 8, 8), torch.float32, 5).requires_grad_())
    xs = _rand((1, 64, 4, 16), torch.float32, 6).requires_grad_()
    with pytest.raises(RuntimeError, match="ssd_scan"):
        tss.ssd_scan(xs, torch.rand((1, 64, 4), device="cuda"), -torch.rand(4, device="cuda"),
                     _rand((1, 64, 1, 16), torch.float32, 7),
                     _rand((1, 64, 1, 16), torch.float32, 8))
    with torch.no_grad():  # serving: no grad mode, the kernels run
        fa.flash_attention(x, k, k)


def test_loss_fn_refuses_the_scan_families_on_the_card():
    from repro_torch.models import build_model, get_config

    for arch in ("mamba2-780m", "recurrentgemma-2b"):
        cfg = dataclasses.replace(get_config(arch, smoke=True), dtype="float32")
        model = build_model(cfg, device="cuda")
        params = model.init_params(torch.Generator("cuda").manual_seed(0))
        tokens = torch.randint(0, cfg.vocab, (2, 17), device="cuda")
        with pytest.raises(NotImplementedError, match="item 5"):
            model.loss_fn(params, {"tokens": tokens})


def test_trainer_loop_raises_the_scan_families_refusal_without_restart(tmp_path):
    from repro_torch.runtime import RunConfig, TrainerLoop

    loop = TrainerLoop(RunConfig(arch="mamba2-780m", smoke=True, steps=2, batch=2, seq=8,
                                 ckpt_dir=str(tmp_path), device="cuda"))
    with pytest.raises(NotImplementedError, match="item 5"):
        loop.run_loop()
    assert loop.restarts == 0
