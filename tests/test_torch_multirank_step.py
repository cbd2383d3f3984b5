"""The sharded train step on 4 gloo ranks on the CPU, against the port's
one-device step and the JAX package's single-device step: llama3.2 smoke
here, dbrx smoke in ``test_torch_multirank_step_moe.py``, mamba2 in
``_ssm.py``, recurrentgemma in ``_hybrid.py``, whisper and the vision
model in ``_cross.py`` and llama with int8 AdamW moments in ``_int8.py``
(each with this file's helpers and gates; ``ALL_ARCHS`` names their
configs).

llama3.2 smoke and dbrx smoke in f32, on (2, 2), (4, 1) and (1, 4)
("data", "model") meshes with ``train_rules`` (FSDP on the embed dim,
heads, vocab, ffn and experts on "model"; on (1, 4) dbrx's 2 kv heads do
not divide the model axis, so KV is replicated while Q is sharded). One
group of 4 ranks (``test_torch_multirank.spawn_group``) runs each (arch,
mesh): ``loss_and_grads`` on the mesh (the scans' operands checked
contiguous, as their CUDA kernels take them: ``kernel_operands_checked``)
and one ``make_train_step(mesh=, rules=)`` step (AdamW at lr 1e-3, f32
moments), gathered whole by rank 0.
Here, in the pytest process, the same weights (``bridged_pair``: the port's
seeded init as the reference's tree) and batch go through the port's step
without a mesh and through the reference's single-device
``jax.value_and_grad(loss_fn)`` and the AdamW update of
``make_train_step`` (its step at one microbatch: that update of those
gradients, jitted alone; its own sharded test fails in the reference,
ROADMAP Queue 3). The loss within 1e-5; each
gradient leaf within 1e-4 of its max-abs (the gates of
``test_torch_train_step.py``); the params after the step where |g| > 1e-3
max|g| of their leaf, within 1e-5 |p| + 1e-6 (Adam's first update is about
lr * sign(g), undetermined where g is all but 0:
``test_torch_train_state.py``'s rule). dbrx runs at capacity factor 8, where
no entry is dropped: the expert-parallel path's per-shard capacity and the
one-device path's global one then route alike (at the config's own 1.25
they drop different entries, in the reference as here; the EP block is held
against the reference's at 1.25 in ``test_torch_multirank.py``). Where the
EP path has more than one token shard (dbrx on (2, 2)) its aux loss is the
mean of the shards' Switch losses (the reference's ``pmean``), not the
whole batch's, so that case weighs the aux loss 0 in both steps (the EP aux
and its gradients are held against the reference's EP in
``test_torch_multirank.py``).
"""
import contextlib
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

from test_torch_multirank import check_case, mesh_of, rank_main, spawn_group  # noqa: E402

ALL_ARCHS = {"llama": ("llama3.2-1b", {}), "dbrx": ("dbrx-132b", {"capacity_factor": 8.0}),
             "mamba2": ("mamba2-780m", {}), "rg": ("recurrentgemma-2b", {}),
             # 3 heads divide no model axis of 2 or 4: the rules replicate q,
             # k, v and wo there, and every model rank runs the attention whole
             # (one group: the attention is what differs)
             "rg_heads3": ("recurrentgemma-2b", {"n_heads": 3, "n_layers": 3}),
             "whisper": ("whisper-large-v3", {}), "vision": ("llama-3.2-vision-90b", {}),
             "llama_int8": ("llama3.2-1b", {})}
# int8 AdamW moments, at a quant block of 16: at the default 64 every
# quantized leaf of the smoke config is split to 16 or 32 columns a shard
# on these meshes, which the step refuses (test_torch_multirank.py's
# refusal case)
INT8_ARCHS = {"llama_int8": 16}
ARCHS = ("llama",)
MESHES = ((2, 2), (4, 1), (1, 4))
LR = 1e-3
BATCH, T = 4, 16


def _cfg(arch):
    import dataclasses

    from repro_torch.models import get_config

    name, kw = ALL_ARCHS[arch]
    return dataclasses.replace(get_config(name, smoke=True), dtype="float32", **kw)


def _aux_weight(arch, shape) -> float:
    """0 where expert parallelism runs over more than one token shard (its
    aux is a mean of per-shard losses), the profile's default elsewhere."""
    from repro_torch.train import TrainProfile

    return 0.0 if arch == "dbrx" and min(shape) > 1 else TrainProfile().aux_weight


def _opt(arch):
    from repro_torch.optim import AdamWConfig, constant

    if arch in INT8_ARCHS:
        return AdamWConfig(lr=constant(LR), int8_state=True, state_block=INT8_ARCHS[arch])
    return AdamWConfig(lr=constant(LR))


def _jax_opt(arch):
    from repro.optim import AdamWConfig as JAdamW
    from repro.optim import constant as jconstant

    if arch in INT8_ARCHS:
        return JAdamW(lr=jconstant(LR), int8_state=True, state_block=INT8_ARCHS[arch])
    return JAdamW(lr=jconstant(LR))


def load_batch(workdir, arch):
    return {k: torch.from_numpy(v) for k, v in np.load(workdir / f"{arch}_batch.npz").items()}


@contextlib.contextmanager
def kernel_operands_checked():
    """``ops.ssd`` and ``ops.rglru_scan`` wrapped to assert what their CUDA
    kernels require of their operands (contiguous: ``ssd_scan._check``,
    ``rglru_scan``'s wrapper), so a CPU run, on their plain versions, fails
    where the card would refuse a block map's operands."""
    from repro_torch.kernels import ops

    def checked(fn, names):
        def wrapper(*args, **kw):
            for name, t in zip(names, args):
                assert t.is_contiguous(), f"{fn.__name__}: {name} is not contiguous"
            return fn(*args, **kw)
        return wrapper

    saved = ops.ssd, ops.rglru_scan
    ops.ssd = checked(ops.ssd, ("x", "dt", "A", "B", "C"))
    ops.rglru_scan = checked(ops.rglru_scan, ("a", "b"))
    try:
        yield
    finally:
        ops.ssd, ops.rglru_scan = saved


def _case(arch, shape):
    def run(rank, workdir):
        from repro_torch.core.distributed import tree_distribute, tree_full
        from repro_torch.launch import train_rules
        from repro_torch.models import build_model, to_jax_layout
        from repro_torch.models.layers import Sharder
        from repro_torch.optim import adamw_init
        from repro_torch.train import TrainProfile, loss_and_grads, make_train_step
        from repro_torch.train.step import place_batch

        cfg = _cfg(arch)
        model = build_model(cfg, device="cpu")
        params = torch.load(workdir / f"{arch}_params.pt")
        batch = load_batch(workdir, arch)
        mesh, rules = mesh_of(shape), train_rules(cfg)
        profile = TrainProfile(aux_weight=_aux_weight(arch, shape))
        step, specs, state_specs = make_train_step(model, _opt(arch), profile, mesh=mesh,
                                                   rules=rules)
        pd = tree_distribute(params, specs, mesh, rules)
        with kernel_operands_checked():
            loss, grads = loss_and_grads(model, pd, place_batch(batch, mesh, rules), profile,
                                         shard=Sharder(mesh, rules))
        grads = to_jax_layout(tree_full(grads), cfg)
        p1, s1, metrics = step(pd, adamw_init(state_specs, "cpu", mesh, rules), batch)
        p1 = to_jax_layout(p1, cfg)
        assert int(s1["step"]) == 1
        loss = float(loss.full_tensor())  # a collective: on every rank
        if rank == 0:
            leaves = {}
            for name, tree in (("grad", grads), ("param", p1)):
                from repro_torch.core.tree import tree_leaves_with_path

                for path, v in tree_leaves_with_path(tree):
                    leaves[f"{name}/{'/'.join(map(str, path))}"] = v
            leaves["loss"] = np.float64(loss)
            leaves["step_loss"] = np.float64(float(metrics["loss"]))
            leaves["grad_norm"] = np.float64(float(metrics["grad_norm"]))
            np.savez(workdir / f"{arch}_{shape[0]}x{shape[1]}.npz", **leaves)
    return run


def cases_of(archs):
    return {f"{arch}_{s[0]}x{s[1]}": _case(arch, s) for arch in archs for s in MESHES}


CASES = cases_of(ARCHS)


def make_pairs(archs):
    """Per arch: (cfg, the JAX model, its params, the port's model, its
    params, the batch as numpy: tokens, and the context's frames or image
    embeddings for whisper and the vision model)."""
    from test_torch_cross_attention import bridged_pair, context_inputs

    out = {}
    for arch in archs:
        name, kw = ALL_ARCHS[arch]
        cfg, model_j, params_j, model, params = bridged_pair(name, seed=0, **kw)
        rng = np.random.default_rng(1)
        batch = {"tokens": rng.integers(0, cfg.vocab, (BATCH, T + 1)).astype(np.int32)}
        if cfg.family in ("encdec", "vlm"):
            batch.update(context_inputs(cfg, BATCH, seed=2))
        out[arch] = (cfg, model_j, params_j, model, params, batch)
    return out


def run_group(script, pairs, workdir):
    """The ranks' results, the workdir, and the one-device references
    (computed here while the ranks run)."""
    for arch, (_, _, _, _, params, batch) in pairs.items():
        torch.save(params, workdir / f"{arch}_params.pt")
        np.savez(workdir / f"{arch}_batch.npz", **batch)
    results = spawn_group(script, workdir, meanwhile=lambda: make_references(pairs))
    return results, workdir, results["_meanwhile"]


@pytest.fixture(scope="module")
def pairs():
    return make_pairs(ARCHS)


@pytest.fixture(scope="module")
def group(pairs, tmp_path_factory):
    return run_group(__file__, pairs, tmp_path_factory.mktemp("multirank_step"))


@pytest.fixture(scope="module")
def references(group):
    return group[2]


def make_references(pairs):
    """Per (arch, aux weight): the port's one-device (loss, grads, params
    after a step, grad_norm) and the reference's single-device ones, as
    numpy leaves in the reference's tree."""
    import jax
    import jax.numpy as jnp

    from repro.core.distributed import tree_initialize
    from repro.optim import adamw_update as jax_adamw_update
    from repro.train import TrainProfile as JProfile
    from repro.train import make_train_step as jax_make_train_step
    from repro_torch.models import to_jax_layout
    from repro_torch.optim import adamw_init
    from repro_torch.train import TrainProfile, loss_and_grads, make_train_step

    out = {}
    for arch, (cfg, model_j, params_j, model, params, np_batch) in pairs.items():
        for aw in sorted({_aux_weight(arch, s) for s in MESHES}):
            batch = {k: torch.from_numpy(v) for k, v in np_batch.items()}
            loss, grads = loss_and_grads(model, params, batch, TrainProfile(aux_weight=aw))
            step, _, state_specs = make_train_step(model, _opt(arch),
                                                   TrainProfile(aux_weight=aw))
            p1, _, m = step(params, adamw_init(state_specs, "cpu"), batch)
            port = {"loss": float(loss), "grad": to_jax_layout(grads, cfg),
                    "param": to_jax_layout(p1, cfg), "grad_norm": float(m["grad_norm"])}
            jb = {k: jnp.asarray(v) for k, v in np_batch.items()}
            (loss_j, _), grads_j = jax.jit(jax.value_and_grad(
                lambda p: model_j.loss_fn(p, jb, aux_weight=aw), has_aux=True))(params_j)
            # the reference's step at one microbatch is its AdamW update of
            # these gradients: jitted alone, not the whole step a second time
            _, pspecs_j, specs_j = jax_make_train_step(model_j, _jax_opt(arch),
                                                       JProfile(aux_weight=aw))
            p1_j, _, m_j = jax.jit(lambda p, g, s: jax_adamw_update(
                p, g, s, pspecs_j, specs_j, _jax_opt(arch)))(
                    params_j, grads_j, tree_initialize(specs_j, jax.random.key(1)))
            ref = {"loss": float(loss_j), "grad": jax.tree.map(np.asarray, grads_j),
                   "param": jax.tree.map(np.asarray, p1_j), "grad_norm": float(m_j["grad_norm"])}
            out[arch, aw] = {"port": port, "jax": ref}
    return out


def _leaves(tree):
    from repro_torch.core.tree import tree_leaves_with_path

    return {"/".join(map(str, p)): np.asarray(v) for p, v in tree_leaves_with_path(tree)}


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_step_runs_on_every_rank(group, case):
    results, workdir, _ = group
    check_case(results, case, workdir)


@pytest.mark.parametrize("against", ["port", "jax"])
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_the_one_device_steps(group, references, arch, shape, against):
    check_step(group, references, arch, shape, against)


def check_step(group, references, arch, shape, against):
    results, workdir, _ = group
    check_case(results, f"{arch}_{shape[0]}x{shape[1]}", workdir)
    got = np.load(workdir / f"{arch}_{shape[0]}x{shape[1]}.npz")
    want = references[arch, _aux_weight(arch, shape)][against]
    assert abs(float(got["loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(float(got["step_loss"]) - want["loss"]) <= 1e-5 * abs(want["loss"])
    assert abs(float(got["grad_norm"]) - want["grad_norm"]) <= 1e-4 * want["grad_norm"]
    grads, params = _leaves(want["grad"]), _leaves(want["param"])
    assert len(grads) == len([k for k in got.files if k.startswith("grad/")])
    checked = total = 0
    for path, g_want in grads.items():
        g = got[f"grad/{path}"]
        tol = 1e-4 * float(np.abs(g_want).max(initial=0.0)) + 1e-7
        assert float(np.abs(g - g_want).max(initial=0.0)) <= tol, (path, against)
        sure = np.abs(g_want) > 1e-3 * np.abs(g_want).max(initial=0.0)
        np.testing.assert_allclose(got[f"param/{path}"][sure], params[path][sure], rtol=1e-5,
                                   atol=1e-6, err_msg=path)
        checked += int(sure.sum())
        total += sure.size
    assert checked > 0.5 * total


if __name__ == "__main__":
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    rank_main(CASES)
