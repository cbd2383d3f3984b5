"""repro_torch's dense-cache serve path in bfloat16 against the reference's,
on bridged weights, for the three smoke configs the path serves (qwen2,
mamba2, recurrentgemma).

Every other parity test runs in float32; the card serves and is timed in
bf16. Here the same weights (the reference's f32 init, cast to each model's
parameter dtypes) and the same numpy tokens (a 16-token prompt, then 5
decode steps fed fixed tokens, so all runs see one input stream) go through
three computations: the port in bf16, the reference in f32 and the
reference in bf16. bf16 rounds at other places in the two frameworks, so the
port cannot equal the reference's bf16 logits; what it must do is stay as
close to the f32 reference as the reference's own bf16 path does. The bound
is 2x the reference's bf16-vs-f32 drift (max |logits| difference over the
prefill's last row and every decode step): a probe of the three configs
found the port's drift at most 1.27x the reference's (recurrentgemma 0.123
against 0.097), and an error of the bf16 path (a lost cast, a sum in bf16)
moves the drift by far more than 2x.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
torch = pytest.importorskip("torch")

from repro.models import build_model as jax_build
from repro.models import get_config as jax_get_config
from repro.serving.step import make_prefill as jax_make_prefill
from repro.serving.step import make_serve_step as jax_make_serve_step
from repro_torch.models import build_model, from_jax_params, get_config
from repro_torch.serving import make_prefill, make_serve_step

ARCHS = ["qwen2-0.5b", "mamba2-780m", "recurrentgemma-2b"]
PROMPT, STEPS = 16, 5
FACTOR = 2.0  # the port's bf16 drift / the reference's own bf16 drift


def _jax_logits(cfg, params, toks, feed):
    model = jax_build(cfg)
    logits, caches = jax_make_prefill(model, max_len=PROMPT + STEPS)(params, jnp.asarray(toks))
    out = [np.asarray(logits[:, -1, :cfg.vocab], dtype=np.float32)]
    step = jax_make_serve_step(model)
    for i in range(STEPS):
        logits, caches = step(params, caches, jnp.asarray(feed[:, i]), jnp.int32(PROMPT + i))
        out.append(np.asarray(logits[:, :cfg.vocab], dtype=np.float32))
    return np.stack(out)


def _torch_logits(cfg, params, toks, feed):
    model = build_model(cfg, device="cpu")
    logits, caches = make_prefill(model, max_len=PROMPT + STEPS)(params, torch.from_numpy(toks))
    out = [logits[:, -1, :cfg.vocab].float().numpy()]
    step = make_serve_step(model)
    for i in range(STEPS):
        logits, caches = step(params, caches, torch.from_numpy(feed[:, i]), PROMPT + i)
        out.append(logits[:, :cfg.vocab].float().numpy())
    return np.stack(out)


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_logits_drift_no_more_than_the_references_own(arch):
    cfg32_j = dataclasses.replace(jax_get_config(arch, smoke=True), dtype="float32")
    cfg16_j = dataclasses.replace(cfg32_j, dtype="bfloat16")
    cfg16 = dataclasses.replace(get_config(arch, smoke=True), dtype="bfloat16")
    params32_j = jax_build(cfg32_j).init_params(jax.random.key(0))
    # the same values in the bf16 model's own parameter dtypes
    params16_j = jax.tree.map(lambda like, x: x.astype(like.dtype),
                              jax_build(cfg16_j).init_params(jax.random.key(0)), params32_j)
    params16 = from_jax_params(jax.tree.map(np.asarray, params16_j), cfg16, device="cpu")
    rng = np.random.default_rng(7)
    toks = rng.integers(0, cfg16.vocab, size=(2, PROMPT)).astype(np.int32)
    feed = rng.integers(0, cfg16.vocab, size=(2, STEPS)).astype(np.int32)

    ref32 = _jax_logits(cfg32_j, params32_j, toks, feed)
    ref16 = _jax_logits(cfg16_j, params16_j, toks, feed)
    port16 = _torch_logits(cfg16, params16, toks, feed)
    assert np.isfinite(port16).all() and port16.shape == ref32.shape
    ref_drift = float(np.abs(ref16 - ref32).max())
    port_drift = float(np.abs(port16 - ref32).max())
    assert ref_drift > 0.0  # the reference's bf16 path really rounds
    assert port_drift <= FACTOR * ref_drift, (port_drift, ref_drift)
