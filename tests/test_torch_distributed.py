"""The port's distribution layer held against the reference, in one process.

``launch.sharding``'s rules and ``core.distributed.ShardingRules.binding_for``
against the reference's for every parameter leaf of all ten architectures,
under train and serve rules, on a (4, 2), a (16, 16) and a (2, 16, 16) mesh
(the reference's ``binding_for`` reads only ``mesh.shape``, so it gets a
stand-in with that dict; the reference's stacked "layers" prefix is dropped
leaf by leaf); ``DistributedLayout`` against the reference's at every index
of small extents, even and uneven; ``configs.shapes``,
``needs_fsdp_for_serving`` and ``rules_for`` against the reference's; and
``placements`` on one- and two-axis bindings. No process group is made.
"""
import dataclasses
import itertools

import pytest
torch = pytest.importorskip("torch")

from repro.configs import shapes as jax_shapes
from repro.core.distributed import DistributedLayout as JaxLayout
from repro.core.extents import Extents as JaxExtents
from repro.core.layouts import LayoutError as JaxLayoutError
from repro.launch import sharding as jax_sharding
from repro.models import build_model as jax_build_model, get_config as jax_get_config
from repro_torch.configs import shapes
from repro_torch.core.distributed import (
    DistributedLayout,
    ShardingRules,
    q_bindings,
    spec_axes,
    tree_param_bytes,
    tree_param_count,
)
from repro_torch.core.extents import Extents
from repro_torch.core.layouts import LayoutError
from repro_torch.launch import sharding
from repro_torch.models import ARCH_IDS, block_program, build_model, get_config
from repro_torch.models.transformer import KINDS
from repro_torch.models.layers import ParamSpec

MESHES = {"(4, 2)": {"data": 4, "model": 2}, "(16, 16)": {"data": 16, "model": 16},
          "(2, 16, 16)": {"pod": 2, "data": 16, "model": 16}}
RULES = ("train", "serve")


class StandInMesh:
    """All that the reference's ``binding_for`` reads of a mesh."""

    def __init__(self, shape):
        self.shape = dict(shape)


class StandInDeviceMesh:
    """All that ``placements`` reads of a DeviceMesh: dim names and sizes."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def _rules(pkg, kind, cfg):
    return pkg.train_rules(cfg) if kind == "train" else pkg.serve_rules(cfg)


def _pairs(port, ref, n_stack=1):
    """(port spec, reference spec, stacked dims) for every leaf, the port's
    per-layer spec beside the reference's stacked one."""
    if isinstance(port, ParamSpec):
        yield port, ref, n_stack
    elif isinstance(port, dict):
        assert set(port) == set(ref), (set(port), set(ref))
        for k in port:
            sub = port[k]
            if isinstance(sub, list):  # a vision group's self layers: (G, 4, ...) stacked
                yield from _pairs(sub[0], ref[k], n_stack + 1)
            else:
                yield from _pairs(sub, ref[k], n_stack)
    else:
        raise TypeError(type(port))


def leaf_pairs(cfg, port_specs, ref_specs):
    """Every parameter leaf: (path, port spec, reference spec, stacked dims)."""
    out = []
    for top in ("embed", "final_norm"):
        out += [(top, a, b, 0) for a, b, _ in _pairs(port_specs[top], ref_specs[top], 0)]
    for i, ((kind, _), layers) in enumerate(zip(block_program(cfg), port_specs["blocks"])):
        layer = layers[0] if layers else KINDS[kind].specs(cfg)
        out += [(f"blocks[{i}]", a, b, n) for a, b, n in _pairs(layer, ref_specs["blocks"][i])]
    if "encoder" in port_specs:
        enc = port_specs["encoder"]
        out += [("encoder", a, b, n) for a, b, n in
                _pairs(enc["blocks"][0][0], ref_specs["encoder"]["blocks"][0])]
        out += [("encoder/final_norm", a, b, 0) for a, b, _ in
                _pairs(enc["final_norm"], ref_specs["encoder"]["final_norm"], 0)]
    return out


@pytest.fixture(scope="module")
def spec_trees():
    trees = {}
    for arch in ARCH_IDS:
        cfg, cfg_j = get_config(arch), jax_get_config(arch)
        trees[arch] = (cfg, cfg_j, build_model(cfg, device="cpu").param_specs(),
                       jax_build_model(cfg_j).param_specs())
    return trees


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_logical_axes_are_the_references(spec_trees, arch):
    cfg, _, port, ref = spec_trees[arch]
    pairs = leaf_pairs(cfg, port, ref)
    assert len(pairs) > 5
    for where, a, b, n in pairs:
        assert b.logical_axes[:n] == ("layers",) * n, (where, b.logical_axes)
        assert spec_axes(a) == tuple(b.logical_axes[n:]), (where, spec_axes(a), b.logical_axes)
        assert tuple(a.shape) == tuple(b.shape[n:]), (where, a.shape, b.shape)


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("kind", RULES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_binding_of_every_leaf_is_the_references(spec_trees, arch, kind, mesh):
    cfg, cfg_j, port, ref = spec_trees[arch]
    sizes = MESHES[mesh]
    rules, rules_j = _rules(sharding, kind, cfg), _rules(jax_sharding, kind, cfg_j)
    assert rules.rules == rules_j.rules
    sharded = 0
    for where, a, b, n in leaf_pairs(cfg, port, ref):
        want = rules_j.binding_for(b.logical_axes, b.shape, StandInMesh(sizes))
        assert want[:n] == (None,) * n
        got = rules.binding_for(spec_axes(a), a.shape, sizes)
        assert got == want[n:], (where, spec_axes(a), a.shape, got, want)
        sharded += any(x is not None for x in got)
    assert sharded  # the table binds something on every mesh


def test_quantized_leaves_bind_as_the_references():
    """Quantized MLP weights: "q" takes the spec's binding (its axes are
    swapped with the output-major storage); "scale" keeps it on its blocked
    last dim only where the block count divides."""
    cfg, cfg_j = get_config("llama3.2-1b"), jax_get_config("llama3.2-1b")
    port = build_model(cfg, quantized=True, device="cpu").param_specs()
    ref = jax_build_model(cfg_j, quantized=True).param_specs()
    rules, rules_j = sharding.train_rules(cfg), jax_sharding.train_rules(cfg_j)
    sizes = MESHES["(16, 16)"]
    seen = 0
    for where, a, b, n in leaf_pairs(cfg, port, ref):
        if a.quant is None:
            continue
        seen += 1
        assert b.is_quantized() and spec_axes(a) == tuple(b.logical_axes[n:]), where
        want = rules_j.binding_for(b.logical_axes, b.shape, StandInMesh(sizes))[n:]
        got = q_bindings(a, sizes, rules)
        assert got["q"] == want
        nblocks = a.shape[-1] // a.quant.block
        last = want[-1] if want[-1] is None or nblocks % sizes[want[-1]] == 0 else None
        assert got["scale"] == want[:-1] + (last,)
    assert seen == 3  # w_gate, w_up, w_down
    spec = ParamSpec((4096, 256), torch.bfloat16, quant=dataclasses.replace(
        port["blocks"][0][0]["mlp"]["w_up"].quant, block=128), logical_axes=("ffn", "model_x"))
    rules2 = ShardingRules({"ffn": "data", "model_x": "model"})
    got = q_bindings(spec, {"data": 4, "model": 4}, rules2)
    assert got == {"q": ("data", "model"), "scale": ("data", None)}  # 2 blocks on 4 ranks


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_accounting_is_the_references(spec_trees, arch):
    from repro.core.distributed import tree_param_bytes as jax_bytes
    from repro.core.distributed import tree_param_count as jax_count

    _, _, port, ref = spec_trees[arch]
    assert tree_param_count(port) == jax_count(ref)
    assert tree_param_bytes(port) == jax_bytes(ref)


LAYOUT_CASES = [((6, 4), ("data", None)), ((6, 4), (None, "model")), ((6, 4), ("data", "model")),
                ((5, 3), ("data", None)), ((7,), ("model",)), ((7, 5), (("data", "model"), None)),
                ((4, 6, 3), (None, "data", "model")), ((4, 6, 3), ("model", None, "data")),
                ((3, 4), (None, None)), ((8, 2), (("data", "model"), None)),
                ((5, 6), (None, ("data", "model")))]
AXIS_SIZES = {"data": 2, "model": 3}


@pytest.mark.parametrize("shape,axes", LAYOUT_CASES)
def test_distributed_layout_is_the_references(shape, axes):
    got = DistributedLayout(Extents.fully_static(*shape), axes, AXIS_SIZES)
    want = JaxLayout(JaxExtents.fully_static(*shape), axes, AXIS_SIZES)
    assert got.local_shape() == want.local_shape()
    for name in ("num_devices_used", "local_span", "required_span_size", "is_unique",
                 "is_contiguous", "is_strided", "is_always_unique"):
        assert getattr(got, name)() == getattr(want, name)(), name
    for idx in itertools.product(*(range(s) for s in shape)):
        assert got(*idx) == int(want(*idx)), idx
        assert got.device_of(*idx) == int(want.device_of(*idx)), idx
        assert got.local_offset(*idx) == int(want.local_offset(*idx)), idx
    for r in range(len(shape)):
        if want.is_strided():
            assert got.stride(r) == want.stride(r)
        else:
            with pytest.raises(JaxLayoutError):
                want.stride(r)
            with pytest.raises(LayoutError):
                got.stride(r)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_shapes_and_serving_policy_are_the_references(arch):
    cfg, cfg_j = get_config(arch), jax_get_config(arch)
    assert cfg.is_subquadratic() == cfg_j.is_subquadratic()
    assert {k: dataclasses.asdict(v) for k, v in shapes.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_shapes.SHAPES.items()}
    for name in shapes.SHAPES:
        assert shapes.cell_is_applicable(cfg, name) == jax_shapes.cell_is_applicable(cfg_j, name)
    assert [s.name for s in shapes.applicable_shapes(cfg)] == \
        [s.name for s in jax_shapes.applicable_shapes(cfg_j)]
    for q in (False, True):
        assert sharding.needs_fsdp_for_serving(cfg, quantized=q) == \
            jax_sharding.needs_fsdp_for_serving(cfg_j, quantized=q)
        for kind in ("train", "prefill", "decode"):
            assert sharding.rules_for(cfg, kind, quantized=q).rules == \
                jax_sharding.rules_for(cfg_j, kind, quantized=q).rules


def test_placements_shard_a_two_axis_binding_in_mesh_order():
    from torch.distributed.tensor import Replicate, Shard

    mesh = StandInDeviceMesh({"pod": 2, "data": 4, "model": 2})
    rules = ShardingRules({"batch": ("pod", "data"), "heads": "model", "embed": "data"})
    assert rules.placements(("batch", None, "heads"), (16, 3, 4), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    # "data" was taken by the batch dim, so "embed" is replicated
    assert rules.placements(("batch", "embed"), (16, 8), mesh) == [Shard(0), Shard(0), Replicate()]
    # the divisibility fallback: 6 heads on 4 x 2 do not divide
    assert rules.placements((None, "batch"), (3, 6), mesh) == [Replicate()] * 3
    assert rules.placements(("heads",), (4,), StandInDeviceMesh({"data": 4, "model": 2})) == \
        [Replicate(), Shard(0)]


def test_placements_refuse_a_binding_against_the_mesh_order():
    mesh = StandInDeviceMesh({"pod": 2, "data": 4, "model": 2})
    rules = ShardingRules({"batch": ("data", "pod")})
    assert rules.binding_for(("batch",), (16,), mesh) == (("data", "pod"),)
    with pytest.raises(ValueError, match="another order"):
        rules.placements(("batch",), (16,), mesh)
