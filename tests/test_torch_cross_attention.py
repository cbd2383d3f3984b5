"""repro_torch's cross-attention pieces against the JAX package: non-causal
attention at Tq != Tk, cross_attention / cross_attention_decode, the cross
decode's route through the dense decode, the plain gelu MLP (dense and int8)
and the sinusoidal table.

The same numpy inputs, made from a seed, go through both packages. The
non-causal attention sweep holds the port's plain ``ops.attention`` against
the reference's Pallas ``flash_attention(causal=False)`` in interpret mode
at Tq 1 / 5 / 16 against Tk 12 / 40 / 131, groups 1 and 4, and the plain
version's 64-key blocks (a tail at 40 and 131) against its one 512-key
block. The Pallas kernels' key blocks divide Tk (12 and 131 whole, 40 in
blocks of 8): in interpret mode the Pallas flash_attention's partial key
block reads NaN padding, which the masked scores' zero weights multiply
into NaN.
The layer tests run on weights drawn from the whisper-smoke and
vision-smoke specs (the port's init, the same values handed to both). All
f32; tolerance 2e-5 for the attention kernels (the reference's f32
kernel-vs-oracle atol; rtol 2e-4), 1e-5 for the layers, 1e-6 for the
table at the smoke size and 1e-4 at whisper's 1500 x 1280 (angles up to
1500 rad: one f32 ulp of the angle is ~1e-4).
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.kernels import ref
from repro.kernels.flash_attention import flash_attention as jflash
from repro.kernels.flash_attention import flash_decode as jdecode
from repro.models import attention as jattn
from repro.models import get_config as jax_get_config
from repro.models import layers as jlayers
from repro.models import transformer as jtransformer
from repro.core.accessors import QuantizedAccessor as JQuant
from repro_torch.core.accessors import QuantizedAccessor
from repro_torch.kernels import ops
from repro_torch.models import attention as tattn
from repro_torch.models import get_config
from repro_torch.models import layers as tlayers
from repro_torch.models import transformer as ttransformer

ATTN = dict(rtol=2e-4, atol=2e-5)
LAYER = dict(rtol=1e-5, atol=1e-5)
ARCHS = ["whisper-large-v3", "llama-3.2-vision-90b"]


def _normal(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _cfg(arch):
    return dataclasses.replace(get_config(arch, smoke=True), dtype="float32")


def _jcfg(arch):
    return dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")


def _np_params(specs, seed):
    """The port's init of ``specs`` as a numpy tree (the values both get)."""
    p = tlayers.init_tree(specs, torch.Generator().manual_seed(seed), "cpu")
    return jax.tree.map(lambda t: t.numpy(), p)


def _to_torch(tree):
    return jax.tree.map(torch.from_numpy, tree)


def _to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


PALLAS_BLOCK_K = {12: 16, 40: 8, 131: 256}  # whole, 5 blocks, whole


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("tq,tk", [(1, 12), (5, 40), (16, 131)])
def test_noncausal_attention_matches_pallas_kernel(tq, tk, hq, hkv):
    """Plain non-causal attention at Tq != Tk against the Pallas kernel
    (interpret mode, 8-row blocks) and the oracle; the plain version's
    64-key blocks (a tail at Tk 40 and 131) equal its one 512-key block."""
    rng = np.random.default_rng(tq * 1000 + tk + hkv)
    q, k, v = _normal(rng, (2, hq, tq, 32)), _normal(rng, (2, hkv, tk, 32)), \
        _normal(rng, (2, hkv, tk, 32))
    want = jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False, block_q=8,
                  block_k=PALLAS_BLOCK_K[tk])
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = ops.attention(qt, kt, vt, causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ATTN)
    oracle = ref.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(oracle), **ATTN)
    tiled = ops.attention(qt, kt, vt, causal=False, block_k=64)
    np.testing.assert_allclose(tiled.numpy(), got.numpy(), **ATTN)


@pytest.mark.parametrize("hq,hkv", [(4, 4), (8, 2)])
@pytest.mark.parametrize("tc", [12, 40, 131])
def test_cross_decode_route_equals_noncausal_attention(tc, hq, hkv):
    """The cross decode runs ops.decode_attention at pos Tc - 1 (the dense
    decode, flash_decode on CUDA): every slot is live there, so it is
    non-causal attention at Tq 1. The plain decode equals plain non-causal
    attention, the reference's Pallas flash_decode at pos Tc - 1 and its
    Pallas flash_attention(causal=False) at Tq 1 (interpret mode)."""
    rng = np.random.default_rng(tc + hkv)
    q, k, v = _normal(rng, (2, hq, 1, 32)), _normal(rng, (2, hkv, tc, 32)), \
        _normal(rng, (2, hkv, tc, 32))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    got = ops.decode_attention(qt, kt, vt, tc - 1)
    np.testing.assert_allclose(got.numpy(), ops.attention(qt, kt, vt, causal=False).numpy(),
                               **ATTN)
    qj, kj, vj = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    bk = PALLAS_BLOCK_K[tc]
    np.testing.assert_allclose(got.numpy(), np.asarray(jdecode(qj, kj, vj, tc - 1, block_k=bk)),
                               **ATTN)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jflash(qj, kj, vj, causal=False, block_q=1, block_k=bk)), **ATTN)


def _cross_layer(arch, seed):
    """(cfg, JAX cfg, one cross-attention layer's params as numpy), drawn
    from the smoke config's cross-attention specs."""
    cfg = _cfg(arch)
    p = _np_params(tattn.cross_attn_specs(cfg), seed)
    return cfg, _jcfg(arch), p


def _ctx_len(cfg):
    return cfg.enc_seq if cfg.family == "encdec" else cfg.n_img_tokens


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_matches_reference(arch):
    """Queries from x (B 2, T 5), keys and values from the context (no RoPE
    on either): the output and the (k, v) the cache keeps."""
    cfg, cfg_j, p = _cross_layer(arch, 0)
    rng = np.random.default_rng(1)
    x = _normal(rng, (2, 5, cfg.d_model))
    ctx = _normal(rng, (2, _ctx_len(cfg), cfg.d_model))
    want, (kj, vj) = jattn.cross_attention(cfg_j, _to_jax(p), jnp.asarray(x), jnp.asarray(ctx),
                                           return_kv=True)
    got, (k, v) = tattn.cross_attention(cfg, _to_torch(p), torch.from_numpy(x),
                                        torch.from_numpy(ctx), return_kv=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    np.testing.assert_allclose(k.numpy(), np.asarray(kj), **LAYER)
    np.testing.assert_allclose(v.numpy(), np.asarray(vj), **LAYER)
    assert k.is_contiguous() and v.is_contiguous()


@pytest.mark.parametrize("arch", ARCHS)
def test_cross_attention_decode_matches_reference(arch):
    """One query row a sequence against cached context K/V (B 2, Hkv, Tc,
    Dh): the reference's non-causal attention at Tq 1."""
    cfg, cfg_j, p = _cross_layer(arch, 2)
    rng = np.random.default_rng(3)
    tc = _ctx_len(cfg)
    x = _normal(rng, (2, 1, cfg.d_model))
    k = _normal(rng, (2, cfg.n_kv_heads, tc, cfg.head_dim))
    v = _normal(rng, (2, cfg.n_kv_heads, tc, cfg.head_dim))
    want = jattn.cross_attention_decode(cfg_j, _to_jax(p), jnp.asarray(x),
                                        (jnp.asarray(k), jnp.asarray(v)))
    got = tattn.cross_attention_decode(cfg, _to_torch(p), torch.from_numpy(x),
                                       (torch.from_numpy(k), torch.from_numpy(v)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)


@pytest.mark.parametrize("quantized", [False, True])
def test_plain_mlp_matches_reference(quantized):
    """whisper's non-gated MLP, gelu_tanh(x @ w_up + b_up) @ w_down + b_down,
    with nonzero biases (the init leaves them 0); with ``quantized`` w_up /
    w_down are int8 {"q", "scale"} (output-major, block 64 at the smoke
    width), applied through quant_matmul's plain version and the
    reference's ref.quant_matmul."""
    cfg = _cfg("whisper-large-v3")
    quant = QuantizedAccessor(torch.float32, bits=8, block=128) if quantized else None
    specs = tlayers.mlp_specs(cfg, quant=quant)
    assert sorted(specs) == ["b_down", "b_up", "w_down", "w_up"]
    p = _np_params(specs, 4)
    rng = np.random.default_rng(5)
    p["b_up"], p["b_down"] = _normal(rng, (cfg.d_ff,), 0.1), _normal(rng, (cfg.d_model,), 0.1)
    assert isinstance(p["w_up"], dict) == quantized
    x = _normal(rng, (2, 7, cfg.d_model))
    want = jlayers.apply_mlp(_jcfg("whisper-large-v3"), _to_jax(p), jnp.asarray(x))
    got = tlayers.apply_mlp(cfg, _to_torch(p), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LAYER)
    jspecs = jlayers.mlp_specs(_jcfg("whisper-large-v3"),
                               quant=JQuant(jnp.float32, bits=8, block=128) if quantized else None)
    assert {n: (s.shape, jnp.dtype(s.dtype).name) for n, s in jspecs.items()} == \
        {n: (s.shape, str(s.dtype).split(".")[1]) for n, s in specs.items()}


@pytest.mark.parametrize("t,d,tol", [(12, 64, 1e-6), (1500, 1280, 1e-4)])
def test_sinusoidal_matches_reference(t, d, tol):
    got = ttransformer._sinusoidal(t, d)
    assert got.dtype == torch.float32 and got.shape == (t, d)
    np.testing.assert_allclose(got.numpy(), np.asarray(jtransformer._sinusoidal(t, d)),
                               rtol=0, atol=tol)
    # [sin | cos] halves: position 0 is zeros then ones
    np.testing.assert_array_equal(got[0].numpy(), np.r_[np.zeros(d // 2), np.ones(d // 2)])


# ---------------------------------------------------------------------------------
# model-level helpers, shared with test_torch_encdec.py and test_torch_vlm.py
# ---------------------------------------------------------------------------------
VISION_GATE = 0.7  # the reference's init sets the gate to 0, where tanh(0) erases the cross layer


def condition_attention(cfg, tree):
    """Rescale every attention projection of a numpy parameter tree, in
    place, to std 1/sqrt(its true fan-in): wq / wk / wv (D, H, Dh) by
    sqrt(H / D), wo (H, Dh, D) by sqrt(1 / Hq). The reference's init draws
    them with std 1/sqrt(H) and 1/sqrt(Dh), so scores are huge and attention
    near-argmax, which amplifies the two packages' different f32 roundings:
    on whisper-smoke's init the serve logits of the encdec tests part by
    more than their 1e-4 at some steps while the tokens agree (take this
    call out of ``bridged_pair`` to see it). ``chip_smoke.py`` conditions
    its deep runs the same way."""
    d, hq = cfg.d_model, cfg.n_heads
    if isinstance(tree, dict):
        if "wq" in tree:
            scales = {"wq": hq / d, "wk": cfg.n_kv_heads / d, "wv": cfg.n_kv_heads / d,
                      "wo": 1.0 / hq}
            for name, sq in scales.items():
                w = tree[name]
                tree[name] = (w.astype(np.float32) * np.float32(math.sqrt(sq))).astype(w.dtype)
        else:
            for v in tree.values():
                condition_attention(cfg, v)
    elif isinstance(tree, list):
        for v in tree:
            condition_attention(cfg, v)


def reference_tree(params):
    """The port's parameters (torch, per layer) as the reference's tree
    (numpy, stacked): each program entry's layers stacked on a leading dim, a
    vision group's list of self layers stacked first (so its leaves are (G,
    4, ...)) and its 0-d gates into (G,), whisper's encoder likewise."""
    def to_np(t):
        if t.dtype == torch.bfloat16:
            return np.asarray(t.float().numpy(), jnp.bfloat16)
        return t.numpy()

    def stack(layers):
        return jax.tree.map(lambda *ls: np.stack([to_np(t) for t in ls]), *layers)

    def group(p):
        if "gate" in p:
            p = dict(p, self=jax.tree.map(lambda *ls: torch.stack(ls), *p["self"]))
        return p

    tree = {
        "embed": jax.tree.map(to_np, params["embed"]),
        "blocks": [stack([group(p) for p in layers]) for layers in params["blocks"]],
        "final_norm": jax.tree.map(to_np, params["final_norm"]),
    }
    if "encoder" in params:
        tree["encoder"] = {"blocks": [stack(params["encoder"]["blocks"][0])],
                           "final_norm": jax.tree.map(to_np, params["encoder"]["final_norm"])}
    return tree


def bridged_pair(arch, seed=0, dtype="float32", quantized=False, gate=VISION_GATE, **cfg_kw):
    """(cfg, JAX model, JAX params, port model, port params) of the smoke
    config (with the fields ``cfg_kw``) on the same weights: the port's init
    (seeded), as the reference's tree (its structure, shapes and dtypes
    asserted against the reference's init, traced with ``jax.eval_shape``),
    the attention projections conditioned (``condition_attention``), every
    vision group's gate set to ``gate``, bridged back with
    ``from_jax_params``. The reference's own init draws each leaf in a
    jitted call, seconds a config on the CPU."""
    from repro.models import build_model as jax_build
    from repro_torch.models import build_model, from_jax_params

    cfg_j = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dtype, **cfg_kw)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype, **cfg_kw)
    model_j = jax_build(cfg_j, quantized=quantized)
    model = build_model(cfg, quantized=quantized, device="cpu")
    tree = reference_tree(model.init_params(torch.Generator().manual_seed(seed)))
    condition_attention(cfg, tree)
    for blocks in tree["blocks"]:
        if "gate" in blocks:
            blocks["gate"] = np.full_like(blocks["gate"], gate)
    ref_shapes = jax.eval_shape(model_j.init_params, jax.random.key(seed))
    assert jax.tree.map(lambda a: (a.shape, jnp.dtype(a.dtype).name), tree) == \
        jax.tree.map(lambda a: (a.shape, a.dtype.name), ref_shapes)
    return cfg, model_j, jax.tree.map(jnp.asarray, tree), model, \
        from_jax_params(tree, cfg, device="cpu")


def context_inputs(cfg, batch, seed=0):
    """The stub frontend's input as numpy f32: whisper's frames (B, enc_seq,
    D) or the vision model's image embeddings (B, n_img_tokens, D)."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal((batch, cfg.enc_seq, cfg.d_model), np.float32)}
    return {"image_embeds": rng.standard_normal((batch, cfg.n_img_tokens, cfg.d_model),
                                                np.float32)}


def serve_pair(pair, prompts, inputs, steps, feed=None):
    """make_prefill(max_len) with batch_inputs, then make_serve_step, in both
    packages on the same prompts and context (in the param dtype), greedy
    unless ``feed`` (B, steps) forces the tokens: (the port's logits a step,
    the reference's, the port's tokens, the reference's, the port's caches,
    the reference's), logits f32 numpy over the real vocabulary."""
    from repro.serving.step import make_prefill as jax_make_prefill
    from repro.serving.step import make_serve_step as jax_make_serve_step
    from repro_torch.serving import make_prefill, make_serve_step

    cfg, model_j, params_j, model, params = pair
    s, v = prompts.shape[1], cfg.vocab
    max_len = s + steps
    bi_j = {k: jnp.asarray(a, cfg.dtype) for k, a in inputs.items()}
    bi_t = {k: torch.from_numpy(a).to(cfg.param_dtype) for k, a in inputs.items()}
    lj, cj = jax_make_prefill(model_j, max_len=max_len)(params_j, jnp.asarray(prompts),
                                                       batch_inputs=bi_j)
    lt, ct = make_prefill(model, max_len=max_len)(params, torch.from_numpy(prompts),
                                                  batch_inputs=bi_t)
    got, want = [lt[:, -1, :v].float().numpy()], [np.asarray(lj[:, -1, :v], np.float32)]
    tj = jnp.argmax(lj[:, -1, :v], axis=-1).astype(jnp.int32)
    tt = torch.argmax(lt[:, -1, :v], dim=-1).to(torch.int32)
    toks_t, toks_j = [tt.tolist()], [np.asarray(tj).tolist()]
    step_j, step_t = jax_make_serve_step(model_j), make_serve_step(model)
    for i in range(steps - 1):
        if feed is not None:
            tj, tt = jnp.asarray(feed[:, i]), torch.from_numpy(feed[:, i])
        lj, cj = step_j(params_j, cj, tj, jnp.int32(s + i))
        lt, ct = step_t(params, ct, tt, s + i)
        got.append(lt[:, :v].float().numpy())
        want.append(np.asarray(lj[:, :v], np.float32))
        tj = jnp.argmax(lj[:, :v], axis=-1).astype(jnp.int32)
        tt = torch.argmax(lt[:, :v], dim=-1).to(torch.int32)
        toks_t.append(tt.tolist())
        toks_j.append(np.asarray(tj).tolist())
    return np.stack(got), np.stack(want), toks_t, toks_j, ct, cj


def assert_caches_equal(ct, cj, **tol):
    """The port's caches against the reference's, leaf by leaf: the same
    nesting, shapes and dtypes, values within ``tol``."""
    flat_t = jax.tree_util.tree_flatten_with_path(jax.tree.map(lambda t: t.float().numpy(), ct))
    flat_j = jax.tree_util.tree_flatten_with_path(cj)
    assert [p for p, _ in flat_t[0]] == [p for p, _ in flat_j[0]]
    for (path, a), (_, b) in zip(flat_t[0], flat_j[0]):
        assert a.shape == b.shape, path
        np.testing.assert_allclose(a, np.asarray(b, np.float32), err_msg=str(path), **tol)
    dt = jax.tree.map(lambda t: str(t.dtype).split(".")[1], ct)
    assert dt == jax.tree.map(lambda a: a.dtype.name, cj)


def bf16_drifts(arch, p32):
    """(the port's bf16 drift, the reference's own) from the reference's f32
    logits, max |difference| over a 16-token prompt's prefill row and 5
    forced steps: both packages' bf16 models on the f32 pair ``p32``'s
    values cast to each bf16 leaf's dtype, the context cast to bf16."""
    from repro_torch.models import from_jax_params

    p16 = bridged_pair(arch, dtype="bfloat16")
    cfg = p32[0]
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg.vocab, size=(2, 16)).astype(np.int32)
    feed = rng.integers(0, cfg.vocab, size=(2, 5)).astype(np.int32)
    inputs = context_inputs(cfg, 2, seed=7)
    params16_j = jax.tree.map(lambda like, x: x.astype(like.dtype), p16[2], p32[2])
    params16 = from_jax_params(jax.tree.map(np.asarray, params16_j), p16[0], device="cpu")
    p16 = (p16[0], p16[1], params16_j, p16[3], params16)
    _, ref32, _, _, _, _ = serve_pair(p32, toks, inputs, 6, feed=feed)
    port16, ref16, _, _, _, _ = serve_pair(p16, toks, inputs, 6, feed=feed)
    assert np.isfinite(port16).all()
    return float(np.abs(port16 - ref32).max()), float(np.abs(ref16 - ref32).max())
