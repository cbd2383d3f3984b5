"""The bf16 flash-attention backward's schedule on the CPU
(kernels/flash_vjp.py): ``bwd_plan``, the planner of the dK/dV split (its
splits at the chip check's shapes, each key tile's walk covered once and in
order, its grids against ``grid_blocks``); ``flash_bwd_split_torch``, the
plain twin of the split schedule, against ``flash_bwd_torch`` and the
reference's ``flash_attention_jnp`` VJP (f32, 1e-5); and the operand rule
of the tensor-core bodies: P and dS fed to their products as hi + lo bf16
pairs pass the card check's bf16 gate, a single bf16 term does not."""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels.flash_vjp import flash_attention_jnp  # noqa: E402
from repro_torch.kernels.flash_attention import attention_torch  # noqa: E402
from repro_torch.kernels.flash_vjp import (  # noqa: E402
    GEOMETRY,
    bwd_plan,
    flash_bwd_split_torch,
    flash_bwd_torch,
    grid_blocks,
    kv_walk,
    split_range,
    tiles,
)

BF16, F32 = torch.bfloat16, torch.float32
SMS = 132  # an H100's SMs
TOL = 1e-5
# (name, B, Hq, Hkv, Tq, Tk, D, causal, window): the card check's BWD_CASES
# and its ragged case
CHIP_CASES = (("llama3.2-1b", 4, 32, 8, 2048, 2048, 64, True, None),
              ("d128", 2, 16, 2, 1024, 1024, 128, True, None),
              ("window64", 2, 32, 8, 1024, 1024, 64, True, 64),
              ("whisper_cross", 4, 20, 20, 448, 1500, 64, False, None),
              ("d256", 1, 8, 1, 512, 512, 256, True, None),
              ("ragged_d128", 1, 12, 4, 777, 777, 128, True, None))
CHIP = {c[0]: c[1:] for c in CHIP_CASES}


# ---------------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------------
@pytest.mark.parametrize("per_sm", [1, 2, 3, 4])
def test_one_split_at_llama_shape(per_sm):
    """llama3.2-1b's 1024 (key tile, kv head, sequence) blocks fill a wave
    of up to 4 resident blocks an SM (the D 64 body's shared memory allows 4)."""
    b, hq, hkv, tq, tk, d, _, _ = CHIP["llama3.2-1b"]
    plan = bwd_plan(b, hq, hkv, tq, tk, d, BF16, SMS, per_sm)
    assert plan.splits == 1 and plan.kv_grid == (32, 8, 4) and plan.dq_grid == (32, 32, 4)


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("case", ["d128", "d256", "ragged_d128"])
def test_small_grids_split(case, per_sm):
    b, hq, hkv, tq, tk, d, _, _ = CHIP[case]
    plan = bwd_plan(b, hq, hkv, tq, tk, d, BF16, SMS, per_sm)
    base = -(-tk // tiles(d, BF16).kv_keys) * hkv * b
    assert base < SMS * per_sm and plan.splits > 1
    # the fewest splits that fill the wave, within the cap
    assert plan.splits == min(GEOMETRY["max_splits"], -(-SMS * per_sm // base))
    assert base * (plan.splits - 1) < SMS * per_sm


def test_split_counts_at_the_chip_shapes():
    got = {name: bwd_plan(*CHIP[name][:6], BF16, SMS, 2).splits for name in CHIP}
    assert got == {"llama3.2-1b": 1, "d128": 5, "window64": 2, "whisper_cross": 1,
                   "d256": 16, "ragged_d128": 6}
    # whisper's cross shape has no group: nothing to split, and no need
    assert bwd_plan(*CHIP["whisper_cross"][:6], BF16, SMS, 8).splits == 1


@pytest.mark.parametrize("case", sorted(CHIP))
def test_f32_never_splits(case):
    b, hq, hkv, tq, tk, d, _, _ = CHIP[case]
    plan = bwd_plan(b, hq, hkv, tq, tk, d, F32, SMS, 1)
    assert plan.splits == 1
    assert plan.kv_grid[0] * plan.kv_grid[1] * plan.kv_grid[2] == \
        grid_blocks(b, hq, hkv, tq, tk, d, F32)[0]


@pytest.mark.parametrize("per_sm", [1, 2, 3])
@pytest.mark.parametrize("case", sorted(CHIP))
def test_grids_equal_grid_blocks(case, per_sm):
    b, hq, hkv, tq, tk, d, _, _ = CHIP[case]
    plan = bwd_plan(b, hq, hkv, tq, tk, d, BF16, SMS, per_sm)
    kv, dq = grid_blocks(b, hq, hkv, tq, tk, d, BF16, plan.splits)
    assert math.prod(plan.kv_grid) == kv and math.prod(plan.dq_grid) == dq
    assert plan.kv_grid[1:] == (hkv, b) and plan.dq_grid[1:] == (hq, b)
    assert max(plan.kv_grid[0], plan.dq_grid[0]) < 2 ** 31 and max(hq, b) <= 65535


def _live_rows(j0, keys, tq, tk, off, causal, window):
    """Query rows with at least one live key in [j0, j0 + keys)."""
    t = np.arange(tq)[:, None] + off
    j = np.arange(j0, min(j0 + keys, tk))[None, :]
    live = np.ones((tq, j.shape[1]), dtype=bool)
    if causal:
        live &= j <= t
    if window is not None:
        live &= j > t - window
    return set(np.nonzero(live.any(axis=1))[0].tolist())


@pytest.mark.parametrize("case", sorted(CHIP) + ["offset", "offset_window", "negative_offset"])
def test_walk_covers_each_item_once_in_order(case):
    """Every (group member, query tile) of each key tile's walk is in exactly
    one split, the splits in walk order, and the walk's rows hold every row
    that can see the tile."""
    extra = {"offset": (1, 6, 2, 70, 200, 128, True, None, 130),
             "offset_window": (1, 4, 1, 90, 300, 64, True, 40, 210),
             "negative_offset": (1, 2, 2, 50, 60, 64, True, 7, -5)}
    if case in extra:
        b, hq, hkv, tq, tk, d, causal, window, off = extra[case]
    else:
        b, hq, hkv, tq, tk, d, causal, window = CHIP[case]
        off = tk - tq if causal else 0
    t = tiles(d, BF16)
    group = hq // hkv
    for splits in sorted({1, 2, 3, bwd_plan(b, hq, hkv, tq, tk, d, BF16, SMS, 1).splits,
                          GEOMETRY["max_splits"]}):
        for j0 in range(0, tk, t.kv_keys):
            t_lo, n_qt = kv_walk(j0, tq, tk, off, causal, window, t.kv_rows, t.kv_keys)
            assert t_lo % t.kv_rows == 0
            items = [i for s in range(splits) for i in range(*split_range(group * n_qt, splits, s))]
            assert items == list(range(group * n_qt))
            rows = {t_lo + i * t.kv_rows + r for i in range(n_qt) for r in range(t.kv_rows)}
            assert _live_rows(j0, t.kv_keys, tq, tk, off, causal, window) <= rows
            assert n_qt == 0 or t_lo + (n_qt - 1) * t.kv_rows < tq


# ---------------------------------------------------------------------------------
# the plain twin of the split schedule
# ---------------------------------------------------------------------------------
# (b, hq, hkv, tq, tk, d, causal, window, q_offset): causal, windowed, GQA,
# Tq != Tk with key tails, at head dims of 64-row and 32-row walk tiles
TWIN_CASES = {
    "causal_gqa": (1, 4, 2, 150, 150, 16, True, None, 0),
    "window_gqa4": (2, 8, 2, 140, 140, 32, True, 40, 0),
    "offset_tail": (1, 6, 2, 70, 200, 16, True, None, 130),
    "cross_tail": (2, 3, 1, 90, 150, 32, False, None, 0),
    "offset_window_d128": (1, 4, 2, 75, 140, 128, True, 48, 65),
}
# the cases also held to the reference's VJP (each costs ~1-2 s of JAX
# compilation): non-causal Tq != Tk with a key tail; GQA, causal, window and
# offset at D 128
REFERENCE_CASES = ("cross_tail", "offset_window_d128")


def _inputs(b, hq, hkv, tq, tk, d, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, tq, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((b, hkv, tk, d), dtype=np.float32),
            rng.standard_normal((b, hq, tq, d), dtype=np.float32))


def _reference_grads(q, k, v, g, causal, window, q_offset):
    def f(q_, k_, v_):
        return flash_attention_jnp(q_, k_, v_, jnp.asarray(q_offset, jnp.int32), causal,
                                   window, None, 512)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(x) for x in vjp(jnp.asarray(g))]


@pytest.mark.parametrize("case", sorted(TWIN_CASES))
def test_split_twin_matches_plain_and_reference(case):
    b, hq, hkv, tq, tk, d, causal, window, off = TWIN_CASES[case]
    arrays = _inputs(b, hq, hkv, tq, tk, d, seed=sorted(TWIN_CASES).index(case))
    q, k, v, g = (torch.from_numpy(x) for x in arrays)
    out, lse = attention_torch(q, k, v, causal=causal, window=window, q_offset=off,
                               return_lse=True)
    kw = dict(causal=causal, window=window, q_offset=off)
    plain = flash_bwd_torch(q, k, v, out, g, lse, **kw)
    ref = _reference_grads(*arrays, causal, window, off) if case in REFERENCE_CASES else None
    t = tiles(d, BF16)
    longest = hq // hkv * -(-tq // t.kv_rows)
    for splits in sorted({1, 2, 3, longest, GEOMETRY["max_splits"]}):
        twin = flash_bwd_split_torch(q, k, v, out, g, lse, splits=splits, **kw)
        for i, (name, a, p) in enumerate(zip(("dq", "dk", "dv"), twin, plain)):
            np.testing.assert_allclose(a.numpy(), p.numpy(), rtol=TOL, atol=TOL,
                                       err_msg=f"{name} splits {splits} vs plain")
            if ref is not None:
                np.testing.assert_allclose(a.numpy(), ref[i], rtol=TOL, atol=TOL,
                                           err_msg=f"{name} splits {splits} vs reference")


def test_split_twin_fully_masked_rows_and_empty_splits():
    """Rows that see no key (q_offset -5, window 3) have zero gradients, and
    splits past a short walk's items leave zeros, not NaN."""
    q, k, v, g = (torch.from_numpy(x) for x in _inputs(1, 4, 1, 20, 30, 16, seed=11))
    out, lse = attention_torch(q, k, v, causal=True, window=3, q_offset=-5, return_lse=True)
    kw = dict(causal=True, window=3, q_offset=-5)
    plain = flash_bwd_torch(q, k, v, out, g, lse, **kw)
    for splits in (1, 16):
        twin = flash_bwd_split_torch(q, k, v, out, g, lse, splits=splits, **kw)
        for a, p in zip(twin, plain):
            assert torch.isfinite(a).all()
            torch.testing.assert_close(a, p, rtol=TOL, atol=TOL)
    assert torch.count_nonzero(plain[0][:, :, :5]) == 0


# ---------------------------------------------------------------------------------
# the bf16 operand rule
# ---------------------------------------------------------------------------------
GATE_RTOL = 1e-4  # chip_smoke.py's BWD_RTOL


def _gate_excess(got, want):
    """The card check's bf16 gate (chip_smoke.py ``_grad_excess``): each
    element within one bf16 ulp of the plain value plus 1e-4 of the
    gradient's max-abs; <= 0 when it holds."""
    w = want.float()
    d = (got.float() - w).abs()
    _, e = torch.frexp(w)
    ulp = torch.ldexp(torch.ones_like(w), e - 8)
    return float((d - ulp - GATE_RTOL * float(w.abs().max())).max())


def _as_bf16_terms(x, terms):
    """x as the tensor cores see it: one bf16 term, or hi + lo."""
    hi = x.to(BF16).float()
    return hi if terms == 1 else hi + (x - hi).to(BF16).float()


def _tensor_core_bwd(q, k, v, out, dout, lse, terms):
    """The bf16 bodies' arithmetic, causal at q_offset Tk - Tq: S and dP from
    the exact bf16 inputs with f32 sums, P (log2 units, as the kernels) and
    dS in f32, each fed to its products as ``terms`` bf16 terms, f32 sums,
    the gradients rounded once."""
    b, hq, tq, d = q.shape
    _, hkv, tk, _ = k.shape
    group = hq // hkv
    scale, log2e = 1.0 / math.sqrt(d), 1.4426950408889634
    qf, kf, vf, of, gf = (t.float() for t in (q, k, v, out, dout))
    kr, vr = kf.repeat_interleave(group, 1), vf.repeat_interleave(group, 1)
    live = torch.arange(tk)[None, :] <= torch.arange(tq)[:, None] + (tk - tq)
    p = torch.where(live, torch.exp2(qf @ kr.transpose(-1, -2) * (scale * log2e)
                                     - lse[..., None] * log2e), torch.zeros(()))
    delta = (gf * of).sum(-1, keepdim=True)
    ds = torch.where(live, p * (gf @ vr.transpose(-1, -2) - delta), torch.zeros(()))
    pt, dst = _as_bf16_terms(p, terms), _as_bf16_terms(ds, terms)
    dv = (pt.transpose(-1, -2) @ gf).reshape(b, hkv, group, tk, d).sum(2)
    dk = (dst.transpose(-1, -2) @ qf * scale).reshape(b, hkv, group, tk, d).sum(2)
    return (dst @ kr * scale).to(BF16), dk.to(BF16), dv.to(BF16)


@pytest.mark.parametrize("terms,passes", [(2, True), (1, False)], ids=["hi_lo", "one_term"])
def test_bf16_operand_rule(terms, passes):
    """At (1, 4 / 1, 512, 64) causal, seed 0: hi + lo passes the gate on dq,
    dk and dv; one bf16 term exceeds it."""
    arrays = _inputs(1, 4, 1, 512, 512, 64, seed=0)
    q, k, v, g = (torch.from_numpy(x).to(BF16) for x in arrays)
    out, lse = attention_torch(q, k, v, causal=True, return_lse=True)
    want = flash_bwd_torch(q, k, v, out, g, lse, causal=True)
    got = _tensor_core_bwd(q, k, v, out, g, lse, terms)
    excess = [_gate_excess(a, w) for a, w in zip(got, want)]
    if passes:
        assert max(excess) <= 0, excess
    else:
        assert min(excess) > 0, excess
