"""The kv_seq-sharded decode's local step and its exact merge, in one process.

A rank of a "model" axis of n holds slots [r * S / n, (r + 1) * S / n) of a
dense (B, Hkv, S, D) cache; its step is ``ops.decode_attention`` over that
slice at local position pos - r * S / n (``key_offset``) with the natural
log-sum-exp out (``return_lse``), and the ranks' partials merge by
``LocalMesh.merge_lse``, whose formula ``core.distributed.merge_lse_parts``
applies to parts held in one process. Here:

* the plain local step over 2 and 4 slices, merged, against
  ``decode_attention_torch`` on the whole cache at D 64 / 112 / 128 / 256 and
  G 1 / 4 / 10, with pos in the first slice, on a slice edge and in the last
  slice, and on a ring (slot i live iff i <= min(pos, S - 1), the port's ring
  law); slices with no live key come out as zeros with lse -inf;
* the emulated ranks' whole step (the in-range write at local slot pos - r *
  s_loc, the local step, the merge) against the reference's
  ``_decode_attention_seq_sharded`` run in a JAX subprocess on 4 host
  devices, on the same numpy inputs: the output and every rank's cache slice
  within 1e-5. Its mesh is ("model",) of 4: on a ("data", "model") mesh of
  (1, 4) the reference's ``shard_map`` raises in this JAX (its ``out_specs``
  P() refer to the non-manual "data" axis; ROADMAP Queue 3), and a "data"
  axis of 1 changes nothing the function computes.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]

DS = (64, 112, 128, 256)
GROUPS = (1, 4, 10)
SLICES = (2, 4)
S = 32
WHERE = {"first": 3, "edge": S // 4 - 1, "last": S - 2}


def _inputs(d, g, seed=0, b=2, hkv=2, s=S):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, hkv * g, 1, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    v = rng.standard_normal((b, hkv, s, d)).astype(np.float32)
    return q, k, v


def _sliced_decode(q, k, v, pos, n):
    """The n ranks' local steps over their slices, merged."""
    from repro_torch.core.distributed import merge_lse_parts
    from repro_torch.kernels import ops

    s_loc = k.shape[2] // n
    outs, lses = [], []
    for r in range(n):
        sl = slice(r * s_loc, (r + 1) * s_loc)
        o, lse = ops.decode_attention(q, k[:, :, sl].contiguous(), v[:, :, sl].contiguous(), pos,
                                      key_offset=r * s_loc, return_lse=True, impl="torch")
        outs.append(o)
        lses.append(lse)
    return merge_lse_parts(outs, lses), outs, lses


@pytest.mark.parametrize("where", list(WHERE))
@pytest.mark.parametrize("n", SLICES)
@pytest.mark.parametrize("g", GROUPS)
@pytest.mark.parametrize("d", DS)
def test_sliced_local_steps_merge_to_the_whole_decode(d, g, n, where):
    from repro_torch.kernels.flash_attention import decode_attention_torch

    q, k, v = (torch.from_numpy(a) for a in _inputs(d, g, seed=d + g + n))
    pos = WHERE[where]
    want = decode_attention_torch(q, k, v, pos)
    got, outs, lses = _sliced_decode(q, k, v, pos, n)
    assert float((got - want).abs().max()) <= 1e-5
    s_loc = S // n
    for r, (o, lse) in enumerate(zip(outs, lses)):
        assert lse.shape == (q.shape[0], q.shape[1], 1) and lse.dtype == torch.float32
        if r * s_loc > pos:  # the slice lies wholly after the token
            assert torch.equal(o, torch.zeros_like(o))
            assert bool(torch.isinf(lse).all()) and bool((lse < 0).all())
        else:
            assert bool(torch.isfinite(lse).all())


@pytest.mark.parametrize("pos", [5, 31, 32, 47, 100])
@pytest.mark.parametrize("n", SLICES)
def test_sliced_ring_steps_merge_to_the_ring_decode(n, pos):
    """A ring of S slots (token p at slot p % S) split over n ranks: each
    rank attends its slice at local position min(pos, S - 1) - r * S / n,
    merged; the whole ring attends slot i <= min(pos, S - 1)."""
    from repro_torch.kernels.flash_attention import decode_attention_torch

    q, k, v = (torch.from_numpy(a) for a in _inputs(128, 4, seed=pos))
    last = min(pos, S - 1)
    want = decode_attention_torch(q, k, v, last)
    got, _, _ = _sliced_decode(q, k, v, torch.tensor([last], dtype=torch.int32), n)
    assert float((got - want).abs().max()) <= 1e-5


def test_local_position_before_and_past_the_slice():
    """A negative local position: zeros and lse -inf; one at or past the
    slice's end: every slot live, equal to the decode at the slice's last
    slot."""
    from repro_torch.kernels import ops

    q, k, v = (torch.from_numpy(a) for a in _inputs(64, 4))
    o, lse = ops.decode_attention(q, k, v, 3, key_offset=10, return_lse=True, impl="torch")
    assert torch.equal(o, torch.zeros_like(o)) and bool(torch.isneginf(lse).all())
    want, want_lse = ops.decode_attention(q, k, v, S - 1, return_lse=True, impl="torch")
    for pos in (S, S + 7, 10 ** 6):
        got, got_lse = ops.decode_attention(q, k, v, pos, return_lse=True, impl="torch")
        assert torch.equal(got, want) and torch.equal(got_lse, want_lse)


def test_partials_take_an_offset():
    """decode_partials_torch counts pos from key_offset, as the local step."""
    from repro_torch.kernels.flash_attention import decode_partials_torch
    from repro_torch.kernels.paged_attention import combine_splits_torch

    q, k, v = (torch.from_numpy(a) for a in _inputs(64, 4))
    m, l, acc = decode_partials_torch(q, k, v, 40, keys_per_split=8, key_offset=30)
    want = decode_partials_torch(q, k, v, 10, keys_per_split=8)
    for a, b in zip((m, l, acc), want):
        assert torch.equal(a, b)
    m, l, acc = decode_partials_torch(q, k, v, 5, keys_per_split=8, key_offset=30)
    assert float(l.abs().max()) == 0.0
    out = combine_splits_torch(m, l, acc)
    assert float(out.abs().max()) == 0.0


# ---------------------------------------------------------------------------------
# against the reference's _decode_attention_seq_sharded on 4 host devices
# ---------------------------------------------------------------------------------
REF_CASES = {  # name -> (d, group, pos): pos on a slice edge, in the first / last slice
    "d64_g4_edge": (64, 4, 15),
    "d128_g1_last": (128, 1, 61),
    "d256_g10_first": (256, 10, 2),
}
REF_S, REF_HKV, REF_B = 64, 2, 2

_JAX_SIDE = r"""
import json, sys
import numpy as np
import jax, jax.numpy as jnp
from types import SimpleNamespace
from repro.models.attention import _decode_attention_seq_sharded
d = sys.argv[1]
cases = json.loads(open(d + "/cases.json").read())
mesh = jax.make_mesh((4,), ("model",))
out = {}
for name, (dh, g, pos) in cases.items():
    a = np.load(d + f"/{name}.npz")
    cfg = SimpleNamespace(n_kv_heads=a["k"].shape[1], head_dim=dh)
    o, c = _decode_attention_seq_sharded(cfg, jnp.asarray(a["q"]), jnp.asarray(a["k_new"]),
                                         jnp.asarray(a["v_new"]),
                                         {"k": jnp.asarray(a["k"]), "v": jnp.asarray(a["v"])},
                                         pos, mesh)
    np.savez(d + f"/{name}_ref.npz", out=np.asarray(o), k=np.asarray(c["k"]), v=np.asarray(c["v"]))
print("ok", len(cases))
"""


def _port_seq_sharded(q, k_new, v_new, k, v, pos, n):
    """The ranks' step as ``attention.self_attention_decode(seq_split=True)``
    runs it, emulated: each rank writes the new K/V at local slot pos - r *
    s_loc when that lies in its slice, attends its slice, and the partials
    merge. -> (out, [each rank's k slice], [v slices])."""
    from repro_torch.core.distributed import merge_lse_parts
    from repro_torch.kernels import ops

    s_loc = k.shape[2] // n
    posv = torch.tensor([pos], dtype=torch.int32)
    outs, lses, ks, vs = [], [], [], []
    for r in range(n):
        ck, cv = k[:, :, r * s_loc:(r + 1) * s_loc].clone(), v[:, :, r * s_loc:(r + 1) * s_loc].clone()
        loc = posv - r * s_loc
        live = (loc >= 0) & (loc < s_loc)
        idx = loc.clamp(0, s_loc - 1).long()
        for c, t in ((ck, k_new), (cv, v_new)):
            c.index_copy_(2, idx, torch.where(live, t, c.index_select(2, idx)))
        o, lse = ops.decode_attention(q, ck, cv, posv, key_offset=r * s_loc, return_lse=True,
                                      impl="torch")
        outs.append(o)
        lses.append(lse)
        ks.append(ck)
        vs.append(cv)
    return merge_lse_parts(outs, lses), ks, vs


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    d = tmp_path_factory.mktemp("seqshard")
    rng = np.random.default_rng(7)
    for name, (dh, g, _) in REF_CASES.items():
        np.savez(d / f"{name}.npz",
                 q=rng.standard_normal((REF_B, REF_HKV * g, 1, dh)).astype(np.float32),
                 k_new=rng.standard_normal((REF_B, REF_HKV, 1, dh)).astype(np.float32),
                 v_new=rng.standard_normal((REF_B, REF_HKV, 1, dh)).astype(np.float32),
                 k=rng.standard_normal((REF_B, REF_HKV, REF_S, dh)).astype(np.float32),
                 v=rng.standard_normal((REF_B, REF_HKV, REF_S, dh)).astype(np.float32))
    (d / "cases.json").write_text(json.dumps(REF_CASES))
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=4",
               JAX_PLATFORMS="cpu",
               PYTHONPATH=os.pathsep.join([str(ROOT / "src"), os.environ.get("PYTHONPATH", "")]))
    res = subprocess.run([sys.executable, "-c", _JAX_SIDE, str(d)], env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-3000:]
    return d


@pytest.mark.parametrize("name", list(REF_CASES))
def test_seq_sharded_decode_equals_the_references(reference, name):
    _, _, pos = REF_CASES[name]
    a = {k: torch.from_numpy(v) for k, v in np.load(reference / f"{name}.npz").items()}
    want = np.load(reference / f"{name}_ref.npz")
    out, ks, vs = _port_seq_sharded(a["q"], a["k_new"], a["v_new"], a["k"], a["v"], pos, 4)
    assert float(np.abs(out.numpy() - want["out"]).max()) <= 1e-5
    s_loc = REF_S // 4
    for r in range(4):
        sl = slice(r * s_loc, (r + 1) * s_loc)
        assert float(np.abs(ks[r].numpy() - want["k"][:, :, sl]).max()) <= 1e-5
        assert float(np.abs(vs[r].numpy() - want["v"][:, :, sl]).max()) <= 1e-5
