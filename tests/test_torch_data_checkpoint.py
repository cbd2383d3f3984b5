"""The port's data pipeline and checkpoint store against the reference's:
``batch_at`` bit-identical for several seeds and steps (SyntheticLM and a
BinaryTokenDataset over a temporary token file), the prefetcher in order;
checkpoints cross-loading in both directions on the reference's layout
(bf16 leaves and int8 {"q", "scale"} moments, names equal to the
reference's ``_leaf_name``), a step_N.tmp that holds its COMMIT ignored by
``latest_step``, keep-N garbage collection and the async ``wait()``."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.checkpoint import store as jstore  # noqa: E402
from repro.core.distributed import tree_initialize  # noqa: E402
from repro.data import BinaryTokenDataset as JBinary  # noqa: E402
from repro.data import DataConfig as JDataConfig  # noqa: E402
from repro.data import SyntheticLM as JSynthetic  # noqa: E402
from repro.models import build_model as jax_build  # noqa: E402
from repro.models import get_config as jax_get_config  # noqa: E402
from repro.optim import AdamWConfig as JAdamW  # noqa: E402
from repro.optim import adamw_init_specs as jax_init_specs  # noqa: E402
from repro_torch.checkpoint import CheckpointManager, latest_step, restore, save  # noqa: E402
from repro_torch.checkpoint.store import _leaf_name  # noqa: E402
from repro_torch.core.tree import tree_leaves_with_path  # noqa: E402
from repro_torch.data import BinaryTokenDataset, DataConfig, SyntheticLM, make_pipeline  # noqa: E402
from repro_torch.models import build_model, from_jax_params, get_config, to_reference_layout  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init, adamw_init_specs  # noqa: E402
from repro_torch.runtime import RunConfig, TrainerLoop  # noqa: E402


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_synthetic_batches_equal_the_reference(seed):
    kw = dict(batch=4, seq=24, vocab=512, seed=seed)
    port, ref = SyntheticLM(DataConfig(**kw)), JSynthetic(JDataConfig(**kw))
    for step in (0, 1, 7, 1000):
        a, b = port.batch_at(step)["tokens"], ref.batch_at(step)["tokens"]
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    two = SyntheticLM(DataConfig(**kw), host_id=1, num_hosts=2).batch_at(5)["tokens"]
    np.testing.assert_array_equal(
        two, JSynthetic(JDataConfig(**kw), host_id=1, num_hosts=2).batch_at(5)["tokens"])


@pytest.mark.parametrize("dtype", ["uint16", "uint32"])
def test_binary_dataset_batches_equal_the_reference(tmp_path, dtype):
    path = tmp_path / "tokens.bin"
    np.random.default_rng(1).integers(0, 50000, 5000).astype(dtype).tofile(path)
    kw = dict(batch=3, seq=32, vocab=50000, seed=2, source="binary", path=str(path), dtype=dtype)
    port, ref = BinaryTokenDataset(DataConfig(**kw)), JBinary(JDataConfig(**kw))
    for step in (0, 4, 99):
        np.testing.assert_array_equal(port.batch_at(step)["tokens"], ref.batch_at(step)["tokens"])
    gen = make_pipeline(DataConfig(**kw), start_step=4, prefetch=False)
    s, b = next(gen)
    assert s == 4
    np.testing.assert_array_equal(b["tokens"], ref.batch_at(4)["tokens"])


def test_prefetcher_yields_in_order():
    cfg = DataConfig(batch=2, seq=8, vocab=64, seed=5)
    pf = make_pipeline(cfg, start_step=3)
    try:
        for want in range(3, 9):
            s, b = next(pf)
            assert s == want
            np.testing.assert_array_equal(b["tokens"], SyntheticLM(cfg).batch_at(want)["tokens"])
    finally:
        pf.close()


def test_leaf_names_equal_the_reference():
    tree = {"params": {"blocks": [{"attn": {"wq": 1}}, {"x-y z": 2}], "embed": {"e": 3}},
            "opt": {"m": {"w": {"q": 4, "scale": 5}}, "step": 6}}
    got = sorted(_leaf_name(p) for p, _ in tree_leaves_with_path(tree))
    want = sorted(jstore._leaf_name(p) for p, _ in jax.tree_util.tree_flatten_with_path(tree)[0])
    assert got == want


def _trees(int8):
    """A bf16 llama3.2-smoke's params and AdamW state: the port's (per
    layer) and the same values in the reference's stacked tree (jax)."""
    cfg = get_config("llama3.2-1b", smoke=True)
    model = build_model(cfg, device="cpu")
    params = model.init_params(torch.Generator().manual_seed(0))
    opt = AdamWConfig(int8_state=int8, state_block=32)
    from repro_torch.models import reference_shapes

    st_specs = adamw_init_specs(model.param_specs(), opt,
                                reference_shapes(model.param_specs(), cfg))
    state = adamw_init(st_specs)
    # moments that are not zero: m from the params, v their squares
    state["m"] = to_reference_layout(params, cfg)  # stacked, then back per layer below
    state["m"] = from_jax_params(state["m"], cfg, device="cpu")
    state["m"] = _requantize(state["m"], st_specs["m"], lambda t: t.float())
    state["v"] = _requantize(from_jax_params(to_reference_layout(params, cfg), cfg, "cpu"),
                             st_specs["v"], lambda t: t.float() ** 2)
    state["step"] = torch.tensor(7, dtype=torch.int32)
    return cfg, params, state


def _requantize(tree, specs, fn):
    from repro_torch.core.distributed import quantize_array
    from repro_torch.core.tree import tree_map

    return tree_map(lambda s, t: quantize_array(fn(t), s.quant) if s.is_quantized() else fn(t),
                    specs, tree)


def _port_ckpt_tree(cfg, params, state):
    ref = lambda t: to_reference_layout(t, cfg, device="cpu")  # noqa: E731
    return {"params": ref(params),
            "opt": {"m": ref(state["m"]), "v": ref(state["v"]), "step": state["step"]}}


def _jax_targets(int8):
    cfg_j = jax_get_config("llama3.2-1b", smoke=True)
    specs = jax_build(cfg_j).param_specs()
    st = jax_init_specs(specs, JAdamW(int8_state=int8, state_block=32))
    return cfg_j, specs, st


@pytest.mark.parametrize("int8", [False, True], ids=["f32_moments", "int8_moments"])
def test_port_checkpoint_restores_in_the_reference(tmp_path, int8):
    cfg, params, state = _trees(int8)
    tree = _port_ckpt_tree(cfg, params, state)
    save(tmp_path, 7, tree)
    assert latest_step(tmp_path) == jstore.latest_step(tmp_path) == 7
    _, specs, st = _jax_targets(int8)
    from repro.core.distributed import tree_shape_structs

    target = {"params": tree_shape_structs(specs), "opt": tree_shape_structs(st)}
    got = jstore.restore(tmp_path, 7, target)
    assert jax.tree.structure(got) == jax.tree.structure(target)
    want = _by_name(tree)
    got = {jstore._leaf_name(p): np.asarray(a)
           for p, a in jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(got) == sorted(want)
    for name, a in got.items():
        b = want[name]
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(_bits(a), _bits(b), err_msg=name)
    assert got["params_embed_embedding"].dtype == jnp.bfloat16


def _bits(a):
    return np.atleast_1d(a).view(np.uint8)


def _by_name(port_tree):
    """The port's tree as {reference leaf name: numpy}."""
    return {_leaf_name(p): _np(t) for p, t in tree_leaves_with_path(port_tree)}


def _np(t):
    if isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return np.asarray(t)


@pytest.mark.parametrize("int8", [False, True], ids=["f32_moments", "int8_moments"])
def test_reference_checkpoint_restores_in_the_port(tmp_path, int8):
    cfg_j, specs, st = _jax_targets(int8)
    params_j = tree_initialize(specs, jax.random.key(0))
    state_j = tree_initialize(st, jax.random.key(1))
    state_j["m"] = jax.tree.map(lambda x: x + 0.25 if x.dtype == jnp.float32 else x, state_j["m"])
    jstore.save(tmp_path, 3, {"params": params_j, "opt": state_j})
    cfg, params, state = _trees(int8)
    target = _port_ckpt_tree(cfg, params, state)
    got = restore(tmp_path, 3, target)
    want = {jstore._leaf_name(p): np.asarray(b) for p, b in
            jax.tree_util.tree_flatten_with_path({"params": params_j, "opt": state_j})[0]}
    got_np = _by_name(got)
    assert sorted(got_np) == sorted(want)
    for name, a in got_np.items():
        assert a.dtype == want[name].dtype and a.shape == want[name].shape, name
        np.testing.assert_array_equal(_bits(a), _bits(want[name]), err_msg=name)
    back = from_jax_params(got["params"], cfg, device="cpu")  # into the port's per-layer tree
    assert torch.equal(back["blocks"][0][1]["attn"]["wq"].view(torch.int16),
                       got["params"]["blocks"][0]["attn"]["wq"][1].view(torch.int16))


def test_latest_step_ignores_an_uncommitted_rename(tmp_path):
    save(tmp_path, 2, {"w": torch.ones(3)})
    tmp = tmp_path / "step_00000004.tmp"
    tmp.mkdir()
    (tmp / "COMMIT").write_text("ok")  # save() writes COMMIT before the rename
    (tmp_path / "step_x").mkdir()
    assert latest_step(tmp_path) == 2
    assert latest_step(tmp_path / "missing") is None


def test_manager_keeps_n_and_waits(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"w": torch.full((4,), float(s)), "b": torch.ones(2, dtype=torch.bfloat16)})
    mgr.wait()
    assert sorted(d.name for d in tmp_path.iterdir()) == ["step_00000003", "step_00000004"]
    assert mgr.latest() == 4
    got = mgr.restore(4, {"w": torch.empty(4, device="meta"),
                          "b": torch.empty(2, dtype=torch.bfloat16, device="meta")}, device="cpu")
    assert torch.equal(got["w"], torch.full((4,), 4.0)) and got["b"].dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError):
        mgr.restore(1, {"w": torch.empty(4)})


def test_manager_surfaces_a_failed_save(tmp_path):
    blocker = tmp_path / "file"
    blocker.write_text("x")
    mgr = CheckpointManager(blocker / "sub", keep=2)  # a directory under a file: fails
    mgr.save(1, {"w": torch.ones(2)})
    with pytest.raises(OSError):
        mgr.wait()


def test_trainer_loop_checkpoint_round_trips_bit_for_bit(tmp_path):
    run = RunConfig(arch="llama3.2-1b", smoke=True, steps=3, batch=2, seq=16, ckpt_dir=str(tmp_path),
                    ckpt_every=100, log_every=100, device="cpu", int8_opt=True)
    loop = TrainerLoop(run)
    out = loop.run_loop()
    assert out["final_step"] == 3 and loop.ckpt.latest() == 3
    params, state = loop.restore(3)
    for a, b in zip(tree_leaves_with_path({"p": params, "s": state}),
                    tree_leaves_with_path({"p": loop.params, "s": loop.opt_state})):
        assert a[0] == b[0] and a[1].dtype == b[1].dtype
        assert torch.equal(a[1].view(-1).view(torch.uint8) if a[1].dim() else a[1],
                           b[1].view(-1).view(torch.uint8) if b[1].dim() else b[1]), a[0]
