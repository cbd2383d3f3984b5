"""Serving on a mesh, on 4 gloo ranks on the CPU, against the JAX package's
one-device serving: qwen2 and llama3.2 smoke here, the other families in
``test_torch_multirank_serve_families.py`` (each with this file's helpers
and gates; ``ALL_ARCHS`` names their configs).

In f32, on (2, 2), (4, 1) and (1, 4) ("data", "model") meshes with
``serve_rules`` (heads, ffn, vocab, lru, ssm heads and experts on "model",
the batch on "data", kv_heads replicated and the dense cache's S on
"model"): the params laid out by the rules (``serving.distribute_params``),
``make_prefill(mesh, rules, max_len)`` over B 4 prompts of 12 tokens, then 8
greedy ``make_serve_step`` steps into a 20-slot cache (S split 2 or 4 ways:
the kv_seq-sharded decode, ``attention.self_attention_decode(seq_split=)``,
with rows of positions in every slice). One group of 4 ranks
(``test_torch_multirank.spawn_group``) runs each (arch, mesh); rank 0 keeps
every step's logits, the greedy tokens and the caches gathered whole.
Here, in the pytest process, the same weights (``bridged_pair``: the port's
seeded init as the reference's tree, bridged back with ``from_jax_params``)
and prompts go through the reference's one-device ``make_prefill`` /
``make_serve_step``. Logits within 1e-4 (rtol and atol, as the one-device
dense-cache test), the greedy tokens identical, and the gathered caches
equal the reference's within that test's 1e-4 / 2e-4.
"""
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from test_torch_multirank import check_case, mesh_of, rank_main, spawn_group  # noqa: E402

ALL_ARCHS = {"qwen2": ("qwen2-0.5b", {}), "llama": ("llama3.2-1b", {}),
             "mamba2": ("mamba2-780m", {}), "rg": ("recurrentgemma-2b", {}),
             "whisper": ("whisper-large-v3", {}), "vision": ("llama-3.2-vision-90b", {}),
             # capacity factor 8: no entry dropped, so the expert-parallel
             # path's per-shard capacity routes as the one-device path's
             # global one (test_torch_multirank_step.py)
             "kimi": ("kimi-k2-1t-a32b", {"capacity_factor": 8.0})}
ARCHS = ("qwen2", "llama")
MESHES = ((2, 2), (4, 1), (1, 4))
BATCH, T, STEPS = 4, 12, 8
TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=1e-4, atol=2e-4)


def serve_cfg(arch):
    import dataclasses

    from repro_torch.models import get_config

    name, kw = ALL_ARCHS[arch]
    return dataclasses.replace(get_config(name, smoke=True), dtype="float32", **kw)


def serve_rules_of(arch, cfg):
    """``serve_rules``, with FSDP on "embed" where the full-size config
    needs it to serve (``needs_fsdp_for_serving``: kimi-k2)."""
    from repro_torch.launch import needs_fsdp_for_serving, serve_rules
    from repro_torch.models import get_config

    return serve_rules(cfg, fsdp_params=needs_fsdp_for_serving(get_config(ALL_ARCHS[arch][0])))


def _inputs(workdir, arch):
    got = dict(np.load(workdir / f"{arch}_inputs.npz"))
    tokens = torch.from_numpy(got.pop("tokens"))
    return tokens, ({k: torch.from_numpy(v) for k, v in got.items()} or None)


def greedy_serve(model, params, tokens, batch_inputs, mesh=None, rules=None):
    """make_prefill + STEPS greedy make_serve_step steps -> (logits (STEPS,
    B, Vp), tokens (STEPS, B), caches)."""
    from repro_torch.serving import make_prefill, make_serve_step

    t = tokens.shape[1]
    logits, caches = make_prefill(model, mesh, rules, max_len=t + STEPS)(
        params, tokens, batch_inputs=batch_inputs)
    step = make_serve_step(model, mesh, rules)
    lg = logits[:, -1]
    outs, toks = [], []
    for i in range(STEPS):
        outs.append(lg)
        tok = torch.argmax(lg[:, :model.cfg.vocab], dim=-1).to(torch.int32)
        toks.append(tok)
        if i < STEPS - 1:
            lg, caches = step(params, caches, tok, t + i)
    return torch.stack(outs), torch.stack(toks), caches


def _case(arch, shape):
    def run(rank, workdir):
        from repro_torch.core.distributed import tree_full
        from repro_torch.core.tree import tree_leaves_with_path
        from repro_torch.models import build_model
        from repro_torch.serving import distribute_params

        cfg = serve_cfg(arch)
        model = build_model(cfg, device="cpu")
        params = torch.load(workdir / f"{arch}_params.pt")
        tokens, bi = _inputs(workdir, arch)
        mesh, rules = mesh_of(shape), serve_rules_of(arch, cfg)
        pd = distribute_params(model, params, mesh, rules)
        logits, toks, caches = greedy_serve(model, pd, tokens, bi, mesh, rules)
        caches = tree_full(caches)  # a collective: on every rank
        if rank == 0:
            out = {"logits": logits.numpy(), "tokens": toks.numpy()}
            for path, t in tree_leaves_with_path(caches):
                out["cache/" + "/".join(map(str, path))] = t.numpy()
            np.savez(workdir / f"{arch}_{shape[0]}x{shape[1]}.npz", **out)
    return run


def cases_of(archs):
    return {f"{arch}_{s[0]}x{s[1]}": _case(arch, s) for arch in archs for s in MESHES}


def case_empty_group_entry(rank, workdir):
    """recurrentgemma smoke at 2 layers: no whole (rec, rec, local_attn)
    group, so the program's group entry has no layer and keeps its (0, ...)
    caches on the mesh too; the port's mesh serve against its one-device
    serve on every mesh."""
    import dataclasses

    from repro_torch.core.distributed import tree_full
    from repro_torch.core.tree import tree_leaves
    from repro_torch.launch import serve_rules
    from repro_torch.models import build_model, get_config
    from repro_torch.serving import distribute_params

    cfg = dataclasses.replace(get_config("recurrentgemma-2b", smoke=True), dtype="float32",
                              n_layers=2)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, cfg.vocab, (BATCH, T)))
    want_l, want_t, want_c = greedy_serve(model, params, tokens, None)
    for shape in MESHES:
        mesh = mesh_of(shape)
        pd = distribute_params(model, params, mesh, serve_rules(cfg))
        got_l, got_t, got_c = greedy_serve(model, pd, tokens, None, mesh, serve_rules(cfg))
        assert torch.equal(got_t, want_t), shape
        torch.testing.assert_close(got_l, want_l, **TOL)
        for a, b in zip(tree_leaves(tree_full(got_c)), tree_leaves(want_c)):
            assert a.shape == b.shape
            torch.testing.assert_close(a, b, **CACHE_TOL)
    assert tree_leaves(want_c[0])[0].shape[0] == 0  # the empty group entry


def case_attention_return_kv(rank, workdir):
    """``self_attention`` / ``cross_attention(return_kv=True)`` alone on
    DTensors (llama smoke, ``serve_rules``: q heads split, kv replicated; and
    under ``train_rules`` with kv heads split too) on (2, 2) and (1, 4): the
    output and the k, v the prefill caches, gathered, equal the unsharded
    call's."""
    import dataclasses

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.core.distributed import distribute, tree_distribute
    from repro_torch.launch import serve_rules, train_rules
    from repro_torch.models import get_config
    from repro_torch.models.attention import attn_specs, cross_attention, self_attention
    from repro_torch.models.layers import Sharder, init_tree

    cfg = dataclasses.replace(get_config("llama3.2-1b", smoke=True), dtype="float32")
    specs = attn_specs(cfg)
    p = init_tree(specs, torch.Generator().manual_seed(4), "cpu")
    x = torch.randn(4, 12, cfg.d_model, generator=torch.Generator().manual_seed(5))
    ctx = torch.randn(4, 8, cfg.d_model, generator=torch.Generator().manual_seed(6))
    want = {"self": self_attention(cfg, p, x, return_kv=True),
            "cross": cross_attention(cfg, p, x, ctx, return_kv=True)}
    for shape in ((2, 2), (1, 4)):
        for rules in (serve_rules(cfg), train_rules(cfg, fsdp=False)):
            mesh = mesh_of(shape)
            pd = tree_distribute(p, specs, mesh, rules)
            pl = rules.placements(("batch", "seq", None), x.shape, mesh)
            xd, cd = distribute(x, mesh, pl), distribute(ctx, mesh, pl)
            with torch.no_grad(), implicit_replication():
                got = {"self": self_attention(cfg, pd, xd, shard=Sharder(mesh, rules),
                                              return_kv=True),
                       "cross": cross_attention(cfg, pd, xd, cd, shard=Sharder(mesh, rules),
                                                return_kv=True)}
            for name, (y, (k, v)) in got.items():
                wy, (wk, wv) = want[name]
                for a, b in ((y, wy), (k, wk), (v, wv)):
                    torch.testing.assert_close(a.full_tensor(), b.detach(), rtol=1e-5, atol=1e-5)


CASES = {**cases_of(ARCHS), "empty_group_entry": case_empty_group_entry,
         "attention_return_kv": case_attention_return_kv}


def make_pairs(archs):
    """Per arch: (cfg, the JAX model, its params, the port's params, the
    numpy inputs: tokens and the context's frames or image embeddings)."""
    from test_torch_cross_attention import bridged_pair, context_inputs

    out = {}
    for arch in archs:
        name, kw = ALL_ARCHS[arch]
        cfg, model_j, params_j, _, params = bridged_pair(name, seed=0, **kw)
        rng = np.random.default_rng(3)
        inputs = {"tokens": rng.integers(0, cfg.vocab, (BATCH, T)).astype(np.int32)}
        if cfg.family in ("encdec", "vlm"):
            inputs.update(context_inputs(cfg, BATCH, seed=4))
        out[arch] = (cfg, model_j, params_j, params, inputs)
    return out


def make_references(pairs):
    """Per arch: the reference's one-device serve (logits, tokens, caches)."""
    import jax
    import jax.numpy as jnp

    from repro.serving.step import make_prefill as jax_make_prefill
    from repro.serving.step import make_serve_step as jax_make_serve_step

    out = {}
    for arch, (cfg, model_j, params_j, _, inputs) in pairs.items():
        tokens = jnp.asarray(inputs["tokens"])
        bi = {k: jnp.asarray(v) for k, v in inputs.items() if k != "tokens"} or None
        logits, caches = jax_make_prefill(model_j, max_len=T + STEPS)(params_j, tokens,
                                                                      batch_inputs=bi)
        step = jax.jit(jax_make_serve_step(model_j))
        lg = logits[:, -1]
        outs, toks = [], []
        for i in range(STEPS):
            outs.append(np.asarray(lg))
            tok = jnp.argmax(lg[:, :cfg.vocab], axis=-1).astype(jnp.int32)
            toks.append(np.asarray(tok))
            if i < STEPS - 1:
                lg, caches = step(params_j, caches, tok, jnp.int32(T + i))
        out[arch] = {"logits": np.stack(outs), "tokens": np.stack(toks),
                     "caches": jax.tree.map(np.asarray, caches)}
    return out


def run_group(script, pairs, workdir):
    for arch, (_, _, _, params, inputs) in pairs.items():
        torch.save(params, workdir / f"{arch}_params.pt")
        np.savez(workdir / f"{arch}_inputs.npz", **inputs)
    results = spawn_group(script, workdir, meanwhile=lambda: make_references(pairs))
    return results, workdir, results["_meanwhile"]


def check_serve(group, arch, shape):
    from repro_torch.core.tree import tree_leaves_with_path

    results, workdir, refs = group
    check_case(results, f"{arch}_{shape[0]}x{shape[1]}", workdir)
    got, want = np.load(workdir / f"{arch}_{shape[0]}x{shape[1]}.npz"), refs[arch]
    np.testing.assert_array_equal(got["tokens"], want["tokens"])
    np.testing.assert_allclose(got["logits"], want["logits"], **TOL)
    leaves = {"cache/" + "/".join(map(str, p)): v for p, v in tree_leaves_with_path(want["caches"])}
    assert sorted(leaves) == sorted(k for k in got.files if k.startswith("cache/"))
    for path, v in leaves.items():
        assert got[path].shape == v.shape, path
        np.testing.assert_allclose(got[path], v, err_msg=path, **CACHE_TOL)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    return run_group(__file__, make_pairs(ARCHS), tmp_path_factory.mktemp("multirank_serve"))


@pytest.mark.parametrize("case", list(cases_of(ARCHS)))
def test_sharded_serve_runs_on_every_rank(group, case):
    results, workdir, _ = group
    check_case(results, case, workdir)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_serve_equals_the_references_one_device_serve(group, arch, shape):
    check_serve(group, arch, shape)


@pytest.mark.parametrize("case", ["empty_group_entry", "attention_return_kv"])
def test_serving_case_across_ranks(group, case):
    results, workdir, _ = group
    check_case(results, case, workdir)


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    rank_main(CASES)
