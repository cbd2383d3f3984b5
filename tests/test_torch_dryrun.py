"""The port's dry run (``repro_torch.launch.dryrun``) and collectives'
inspector (``launch.inspect_colls``) against the reference's and the card's
figures.

Every fake world runs in a subprocess (this file run as ``python FILE PART
OUT``), so no process group is left in the pytest worker; the parts and the
JAX side run at once:

* ``layout``: on a fake (2, 4) ("data", "model") mesh, one smoke cell per
  family (llama3.2, kimi-k2 at d_model 128 so that its int8 moments' blocks
  lie whole in a shard, mamba2, recurrentgemma, whisper, vision) and kind
  (train, prefill, decode): rank 0's local bytes of the params, moments and
  caches the cell builds; llama3.2's three cells traced whole (argument
  bytes, flops, collective records); ``fake_world``'s refusal inside a gloo
  group; llama3.2-1b's ``decode_32k`` on the production mesh with its
  probes beside ``inspect_colls`` at units 1, and the skipped ``long_500k``
  cell;
* ``decode``: llama3.2-1b's bf16 dense-cache decode step at full width on a
  fake (1, 4) mesh (B 8, 32768 slots, ``serve_rules``), the cell whose
  collectives PERF.md records from 4 H100s (PR 35); dbrx-smoke's train cell
  (4 microbatches) traced whole beside its fit, with and without
  ``force_single_microbatch``;
* ``probes``: for each family the two-probe fit at 3 units against a direct
  3-unit trace (smoke train cells on (2, 2));
* the JAX side: the reference's shard shapes of the same specs on a (2, 4)
  mesh of 8 host devices (``tree_shape_structs``, ``sharding.shard_shape``);
  of llama3.2-smoke's three cells, compiled with their layers unrolled as
  the reference's probes are, ``memory_analysis()``, ``cost_analysis()``'s
  flops, the flops of the module's dots and ``collective_stats``; and
  ``collective_stats`` of one HLO op of each kind, group size and dtype.
"""
import json
import math
import os
import subprocess
import sys
from pathlib import Path

import pytest
torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
LAYOUT_MESH = (2, 4)
FAMILY_ARCHS = {"dense": "llama3.2-1b", "moe": "kimi-k2-1t-a32b", "ssm": "mamba2-780m",
                "hybrid": "recurrentgemma-2b", "encdec": "whisper-large-v3",
                "vlm": "llama-3.2-vision-90b"}
# int8 moment blocks whole in a (2, 4) shard
WIDER = {"kimi-k2-1t-a32b": {"d_model": 128}, "dbrx-132b": {"d_model": 128}}
SMOKE_SHAPES = {"train": ("smoke_train", 32, 16), "prefill": ("smoke_prefill", 32, 4),
                "decode": ("smoke_decode", 32, 4)}
TIMED = dict(batch=8, slots=32768)  # scripts/sharded_serve_ranks.py::TIMED
CARD_COUNTS = {"calls": {"allreduce_": 65, "_allgather_base_": 17},  # PERF.md §6, PR 35
               "input_bytes": {"allreduce_": 2162688, "_allgather_base_": 3220480}}
PARTS = ("layout", "decode", "probes")
REF_KEY_BLOCK = 512  # repro/kernels/ops.py::attention_jnp's block_k, to which it pads the keys


def smoke_cfg(arch):
    import dataclasses

    from repro_torch.models import get_config

    return dataclasses.replace(get_config(arch, smoke=True), **WIDER.get(arch, {}))


def smoke_shape(kind):
    from repro_torch.configs.shapes import Shape

    name, seq, batch = SMOKE_SHAPES[kind]
    return Shape(name, kind, seq, batch)


# ---------------------------------------------------------------------------------
# the parts (subprocesses)
# ---------------------------------------------------------------------------------
def part_layout(out):
    import tempfile

    import torch.distributed as dist

    from repro_torch.launch import dryrun as dr
    from repro_torch.launch import inspect_colls

    res = {"bytes": {}, "traced": {}}
    with dr.fake_world(8):
        mesh = dr.make_mesh(False, LAYOUT_MESH)
        for fam, arch in FAMILY_ARCHS.items():
            for kind in SMOKE_SHAPES:
                with torch._subclasses.fake_tensor.FakeTensorMode(allow_non_fake_inputs=True):
                    _, args, groups = dr.build_cell(arch, smoke_shape(kind), mesh,
                                                    cfg_override=smoke_cfg(arch))
                    by = {}
                    for g, a in zip(groups, args):
                        by[g] = by.get(g, 0) + dr.local_bytes(a)
                res["bytes"][f"{arch}/{kind}"] = by
        for kind in SMOKE_SHAPES:
            tracer, fig, groups = dr.trace_cell("llama3.2-1b", smoke_shape(kind), mesh,
                                                cfg_override=smoke_cfg("llama3.2-1b"))
            res["traced"][kind] = {"argument_bytes_by_group": groups, "flops": fig["flops"],
                                   "cost_keys": fig["cost_keys"],
                                   "records": tracer.collectives}
    with tempfile.TemporaryDirectory() as d:
        # the refusal inside a real group, and no group left behind
        dist.init_process_group("gloo", init_method=f"file://{d}/store", world_size=1, rank=0)
        try:
            with dr.fake_world(4):
                res["refused"] = None
        except RuntimeError as e:
            res["refused"] = str(e)
        finally:
            dist.destroy_process_group()
    with dr.fake_world(4):
        res["inside"] = dist.is_initialized() and dist.get_world_size()
    res["after"] = dist.is_initialized()
    with tempfile.TemporaryDirectory() as d:
        r = dr.run_cell("llama3.2-1b", "decode_32k", False, Path(d))
        res["cell"] = {k: r.get(k) for k in ("ok", "error", "world", "extrapolated",
                                             "figures_from", "collective_calls", "memory",
                                             "argument_bytes_by_group")}
        rows = inspect_colls.probe_collectives("llama3.2-1b", "decode_32k", units=1)
        res["inspect"] = {"rows": len(rows),
                          "moved": dr.collective_stats(rows)["moved_bytes_per_device"]}
        res["skip"] = dr.run_cell("llama3.2-1b", "long_500k", False, Path(d))
    out.write_text(json.dumps(res))


def part_decode(out):
    import tempfile

    from repro_torch.configs.shapes import Shape
    from repro_torch.launch import dryrun as dr

    with dr.fake_world(4):
        mesh = dr.make_mesh(False, (1, 4))
        shape = Shape("decode_timed", "decode", TIMED["slots"], TIMED["batch"])
        tracer = dr.trace_cell("llama3.2-1b", shape, mesh)[0]
    res = {"counts": {"calls": tracer.counter.calls, "input_bytes": tracer.counter.bytes},
           "microbatches": {}}
    with tempfile.TemporaryDirectory() as d:
        for single in (False, True):
            r = dr.run_cell("dbrx-132b", smoke_shape("train"), False, Path(d), full=True,
                            mesh_shape=(2, 2), cfg_override=smoke_cfg("dbrx-132b"),
                            force_single_microbatch=single)
            res["microbatches"][str(single)] = {k: r.get(k) for k in ("ok", "error", "microbatches",
                                                                      "extrapolated")}
    out.write_text(json.dumps(res))


def part_probes(out):
    from repro_torch.launch import dryrun as dr

    res = {"fit": {}}
    with dr.fake_world(4):
        mesh = dr.make_mesh(False, (2, 2))
        for arch in FAMILY_ARCHS.values():
            cfg, shape = smoke_cfg(arch), smoke_shape("train")
            m = [dr.probe(arch, shape, mesh, u, cfg=cfg) for u in (1, 2, 3)]
            res["fit"][arch] = {"fit": dr.fit_tree(m[0], m[1], 3.0), "direct": m[2]}
    out.write_text(json.dumps(res))


# ---------------------------------------------------------------------------------
# the reference's side
# ---------------------------------------------------------------------------------
JAX_SIDE = r"""
import dataclasses, json, math, re, sys
import jax
jax.devices()  # 8 host devices, before the reference's dryrun module sets 512
import numpy as np
from repro.configs import shapes as shp
from repro.core.distributed import tree_shape_structs
from repro.launch import dryrun as rd
from repro.launch.sharding import rules_for
from repro.models import build_model, get_config
from repro.models import transformer as tf
from repro.train import make_train_step

spec = json.loads(sys.argv[1])
# Auto axes: jax.make_mesh's default (Explicit in this JAX) refuses the
# reference's train step (the embedding's gather; ROADMAP Queue 3's
# test_multidevice fault)
mesh = jax.make_mesh(tuple(spec["mesh"]), ("data", "model"),
                     axis_types=(jax.sharding.AxisType.Auto,) * 2)


def cfg_of(arch):
    return dataclasses.replace(get_config(arch, smoke=True), **spec["wider"].get(arch, {}))


def nbytes(shape, dtype):
    return math.prod(shape) * np.dtype(dtype).itemsize


def local(tree):
    total = 0
    for leaf in jax.tree.leaves(tree):
        total += nbytes(leaf.sharding.shard_shape(leaf.shape), leaf.dtype)
    return total


DEF = re.compile(r"^\s*(?:ROOT\s+)?%([\w.\-]+)\s*=\s*\w+\[([\d,]*)\]")
DOT = re.compile(r"=\s*\w+\[([\d,]*)\]\S*\s+dot\(%([\w.\-]+),.*lhs_contracting_dims=\{([\d,]*)\}")


def dims(s):
    return [int(d) for d in s.split(",") if d]


def dot_flops(hlo):
    # 2 x the result's elements x the contracted size, over every dot of the
    # per-device module; those with batch dims (the attention's) apart
    lines = hlo.splitlines()
    shapes = {m.group(1): dims(m.group(2)) for m in map(DEF.match, lines) if m}
    out = {"attention": 0, "other": 0}
    for line in lines:
        m = DOT.search(line)
        if m:
            lhs = shapes[m.group(2)]
            f = 2 * math.prod(dims(m.group(1))) * math.prod(lhs[i] for i in dims(m.group(3)))
            out["attention" if "lhs_batch_dims" in line else "other"] += f
    return out


def synthetic(world=32):
    # the reference's collective_stats of one HLO op of each kind, group size
    # and dtype
    rows = []
    for op in rd._COLL_OPS:
        for n in (2, 4, 16):
            for dt in ("bf16", "f32"):
                shape = [8, 3] if op == "reduce-scatter" else [8 * n, 3]
                groups = ("source_target_pairs={{0,1}}" if op == "collective-permute"
                          else f"replica_groups=[{world // n},{n}]<=[{world}]")
                line = (f"  %c = {dt}[{shape[0]},{shape[1]}]{{1,0}} {op}(%p), channel_id=1, "
                        f"{groups}")
                rows.append({"op": op, "n": n, "dtype": dt, "result_shape": shape,
                             "stats": rd.collective_stats(line, world)})
    return rows


out = {"bytes": {}, "memory": {}, "compiled": {}, "synthetic": synthetic()}
for arch in spec["archs"]:
    cfg = cfg_of(arch)
    for kind, (name, seq, batch) in spec["shapes"].items():
        shape = shp.Shape(name, kind, seq, batch)
        shp.SHAPES[name] = shape
        rules = rules_for(cfg, kind)
        model = build_model(cfg)
        rec = {"params": local(tree_shape_structs(model.param_specs(), mesh, rules))}
        if kind == "train":
            opt, profile = rd.train_profile_for(arch)
            _, _, sspecs = make_train_step(model, opt, profile, mesh=mesh, rules=rules)
            rec["moments"] = local(tree_shape_structs(sspecs, mesh, rules))
        if kind == "decode":
            rec["caches"] = local(tree_shape_structs(model.cache_specs(batch, seq), mesh, rules))
        rec["inputs"] = local(rd.input_specs(cfg, shape, mesh, rules))
        out["bytes"][f"{arch}/{kind}"] = rec
        if arch == "llama3.2-1b":
            tf.set_scan_unroll(True)  # the reference's probes: cost analysis sees every layer
            try:
                with mesh:
                    fn, args = rd.build_cell(arch, name, mesh, cfg_override=cfg)
                    args = [a for a in args if a is not None]
                    compiled = fn.lower(*args).compile()
            finally:
                tf.set_scan_unroll(False)
            out["memory"][kind] = int(compiled.memory_analysis().argument_size_in_bytes)
            hlo = compiled.as_text()
            cost = compiled.cost_analysis() or {}
            cost = cost[0] if isinstance(cost, list) else cost
            out["compiled"][kind] = {"flops": float(cost.get("flops", -1)),
                                     "dot_flops": dot_flops(hlo), "loops": hlo.count(" while("),
                                     "collectives": rd.collective_stats(hlo, 8)}
print("JAX-SIDE-OK " + json.dumps(out))
"""


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    d = tmp_path_factory.mktemp("dryrun")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(ROOT / "src"),
                                                       os.environ.get("PYTHONPATH", "")]),
               OMP_NUM_THREADS="1")
    procs = {p: subprocess.Popen([sys.executable, __file__, p, str(d / f"{p}.json")], env=env,
                                 stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for p in PARTS}
    spec = {"mesh": LAYOUT_MESH, "archs": list(FAMILY_ARCHS.values()), "wider": WIDER,
            "shapes": SMOKE_SHAPES}
    jax_env = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=8",
                   JAX_PLATFORMS="cpu")
    side = subprocess.run([sys.executable, "-c", JAX_SIDE, json.dumps(spec)], env=jax_env,
                          capture_output=True, text=True, timeout=600)
    out = {}
    for p, proc in procs.items():
        log, _ = proc.communicate(timeout=600)
        path = d / f"{p}.json"
        out[p] = json.loads(path.read_text()) if proc.returncode == 0 and path.exists() else None
        out[f"{p}_log"] = log[-3000:]
    line = [ln for ln in side.stdout.splitlines() if ln.startswith("JAX-SIDE-OK ")]
    out["jax"] = json.loads(line[0][len("JAX-SIDE-OK "):]) if line else None
    out["jax_log"] = side.stdout[-2000:] + side.stderr[-3000:]
    return out


def _part(results, name):
    assert results[name] is not None, results[f"{name}_log"]
    return results[name]


def test_params_equal_the_references_count_for_every_arch():
    """``params_total`` / ``params_active`` of every cell, for the ten archs at
    full size (spec trees only), equal the reference's ``count_params``."""
    from repro.models import ARCH_IDS
    from repro.models import count_params as ref_count
    from repro.models import get_config as ref_config

    from repro_torch.launch.dryrun import params_of
    from repro_torch.models import get_config

    for arch in ARCH_IDS:
        want = {"params_total": ref_count(ref_config(arch)),
                "params_active": ref_count(ref_config(arch), active_only=True)}
        assert params_of(get_config(arch)) == want, arch


@pytest.mark.parametrize("cell", [f"{a}/{k}" for a in FAMILY_ARCHS.values()
                                  for k in SMOKE_SHAPES])
def test_local_bytes_equal_the_references_shard_shapes(results, cell):
    """Rank 0's bytes of the params, moments and caches of a smoke cell on
    (2, 4) equal the sums of the reference's shard shapes of the same specs.
    An int8 moment on a mesh encodes each rank's own q shard, one scale a
    block of its local last dim (ROADMAP Queue 3), where the reference's
    scale keeps its last dim's binding only where the block count divides
    it; wherever the port admits the leaf (``train.step.check_mesh``: the
    local last dim a multiple of the block) the block count divides, so the
    two lay out the same bytes: kimi's int8 moments are held here too."""
    port = _part(results, "layout")["bytes"][cell]
    assert results["jax"] is not None, results["jax_log"]
    ref = results["jax"]["bytes"][cell]
    for group in ("params", "moments", "caches"):
        assert (group in port) == (group in ref), (group, port, ref)
        if group in ref:
            assert port[group] == ref[group], (group, port[group], ref[group])


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
def test_argument_size_against_the_references_memory_analysis(results, kind):
    """llama3.2-smoke's traced ``argument_size_in_bytes`` on (2, 4) against
    the reference's ``compiled.memory_analysis()``: equal in the params,
    moments and caches; apart by design in the inputs only, which the
    port's steps take whole on every rank where the reference's are sharded
    over the batch axes (and where the reference's decode takes ``pos`` as a
    4-byte int32 array and the port's a Python int)."""
    traced = _part(results, "layout")["traced"][kind]
    assert results["jax"] is not None, results["jax_log"]
    ref = results["jax"]["bytes"][f"llama3.2-1b/{kind}"]
    ref_arg = results["jax"]["memory"][kind]
    groups = traced["argument_bytes_by_group"]
    state = sum(v for g, v in groups.items() if g != "inputs")
    ref_state = sum(ref[g] for g in ("params", "moments", "caches") if g in ref)
    assert state == ref_state
    ref_inputs = ref_arg - ref_state
    name, seq, batch = SMOKE_SHAPES[kind]
    whole = {"train": batch * (seq + 1), "prefill": batch * seq, "decode": batch}[kind] * 4
    assert groups["inputs"] == whole
    assert ref_inputs == ref["inputs"], (ref_inputs, ref)  # decode: tokens and pos


@pytest.mark.parametrize("kind", list(SMOKE_SHAPES))
def test_flops_against_the_references_dot_flops(results, kind):
    """llama3.2-smoke's traced flops on (2, 4) against the dots of the
    reference's compiled per-device module (its probes' unrolled layers).
    One departure is exact: the reference's plain attention pads the keys
    to its 512-key block (``repro/kernels/ops.py::attention_jnp``), so where the blocked path runs (train, prefill; not
    the decode step, which attends over the cache's slots) its attention
    dots are 512 / T times the port's bmm. The rest lies within 15%: the
    two partitioners share the GQA projections out differently (with 2 kv
    heads on 4 model ranks the port's ranks each project both kv heads,
    replicated as ``rules_for`` lays wk / wv out, where XLA's partitioner
    splits those products over the tokens). The reference's whole
    ``cost_analysis()`` flops, elementwise ops among them, bound it above."""
    traced = _part(results, "layout")["traced"][kind]
    assert results["jax"] is not None, results["jax_log"]
    ref = results["jax"]["compiled"][kind]
    assert ref["loops"] == 0  # every dot of the module runs once
    att, other = ref["dot_flops"]["attention"], ref["dot_flops"]["other"]
    seq = SMOKE_SHAPES[kind][1]
    pad = 1 if kind == "decode" else -(-seq // REF_KEY_BLOCK) * REF_KEY_BLOCK / seq
    port = traced["flops"]
    if kind != "decode":
        assert traced["cost_keys"]["bmm"] * pad == att, (traced["cost_keys"], att)
    want = other + att / pad
    assert abs(port / want - 1) <= 0.15, (port, want, ref)
    assert port < ref["flops"]


def _ref_stats(rows):
    """The port's ``collective_stats`` of records whose bytes are scaled to
    the reference's lowering: a bf16 collective counts twice its bytes, as
    XLA:CPU legalises bf16 to f32 before the collective (the reference's own
    ``moved_bytes_tpu`` note)."""
    from repro_torch.launch.dryrun import collective_stats

    scaled = [dict(r, input_bytes=r["input_bytes"] * (2 if r["dtype"] == "torch.bfloat16" else 1))
              for r in rows]
    return collective_stats(scaled)["per_op"]


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_collectives_against_the_references(results, kind):
    """llama3.2-smoke's prefill and decode collectives on (2, 4) against the
    reference's ``collective_stats`` of its compiled module: per kind, equal
    counts, result bytes and moved bytes, after two named departures. (1)
    XLA:CPU runs the bf16 collectives in f32 (``_ref_stats``). (2) The port's
    serve head returns the logits whole on every rank (``Model._head_mesh``:
    the vocab's model shards gathered in its block map's ``body``, then the
    batch's data shards by ``full_tensor``), where the reference's jit leaves
    them sharded: two all-gathers the reference has not.

    The train cell is held elsewhere: there XLA's partitioner picks its own
    schedule (reductions combined into tuple all-reduces, gradients
    all-reduced where the port reduce-scatters them, heads and the
    embedding's gather resharded by collective-permute and all-to-all), so
    its kinds do not line up op for op; its collectives are held against 4
    real gloo ranks (``test_torch_multirank_dryrun.py``) and the formula of
    every kind against the reference's here
    (``test_collective_formula_against_the_references``)."""
    rows = _part(results, "layout")["traced"][kind]["records"]
    assert results["jax"] is not None, results["jax_log"]
    ref = results["jax"]["compiled"][kind]["collectives"]["per_op"]
    head = [r for r in rows if r["origin"].startswith("models/transformer.py:")
            and r["origin"].split()[-1] in ("body", "_head_mesh")]
    assert sorted((r["op"], r["group_size"]) for r in head) == \
        [("_allgather_base_", LAYOUT_MESH[1]), ("all_gather_into_tensor", LAYOUT_MESH[0])], head
    got = _ref_stats([r for r in rows if r not in head])
    for op, want in ref.items():
        assert got[op]["count"] == want["count"], (op, got, ref)
        assert got[op]["result_bytes"] == want["result_bytes"], (op, got, ref)
        assert got[op]["moved_bytes"] == pytest.approx(want["moved_bytes"], rel=1e-12), op


C10D_OP = {"all-gather": "_allgather_base_", "all-reduce": "allreduce_",
           "reduce-scatter": "_reduce_scatter_base_", "all-to-all": "alltoall_base_",
           "collective-permute": "send"}
FUNCTIONAL_OP = {"all-gather": "all_gather_into_tensor", "all-reduce": "all_reduce",
                 "reduce-scatter": "reduce_scatter_tensor", "all-to-all": "all_to_all_single"}


@pytest.mark.parametrize("op", list(C10D_OP))
def test_collective_formula_against_the_references(results, op):
    """One collective of each kind, group size (2, 4, 16) and dtype, as an
    HLO op through the reference's ``collective_stats`` and as the record of
    the port's call (its c10d and its functional name) through the port's:
    equal counts, result bytes and moved bytes, but for one named departure:
    a reduce-scatter's moved bytes are n times the reference's, as the port
    takes the ring's term from the whole buffer the rank hands the op and
    the reference from the result shard (``launch/dryrun.py``'s docstring)."""
    from repro_torch.launch.dryrun import collective_stats

    assert results["jax"] is not None, results["jax_log"]
    rows = [r for r in results["jax"]["synthetic"] if r["op"] == op]
    assert len(rows) == 6
    for row in rows:
        n, width = row["n"], {"bf16": 2, "f32": 4}[row["dtype"]]
        result = math.prod(row["result_shape"]) * width
        handed = {"all-gather": result // n, "reduce-scatter": result * n}.get(op, result)
        dtype = {"bf16": "torch.bfloat16", "f32": "torch.float32"}[row["dtype"]]
        ref = row["stats"]
        scale = n if op == "reduce-scatter" else 1
        for name in (C10D_OP[op], FUNCTIONAL_OP.get(op, C10D_OP[op])):
            got = collective_stats([{"op": name, "input_bytes": handed, "dtype": dtype,
                                     "group_size": n}])
            assert got["per_op"][op]["count"] == ref["per_op"][op]["count"] == 1
            assert got["per_op"][op]["result_bytes"] == ref["per_op"][op]["result_bytes"], row
            assert got["per_op"][op]["moved_bytes"] == pytest.approx(
                ref["per_op"][op]["moved_bytes"] * scale, rel=1e-12), row
            assert got["moved_bytes_f32"] == pytest.approx(ref["moved_bytes_f32"] * scale,
                                                           rel=1e-12), row


def test_decode_step_counts_what_four_cards_counted(results):
    """llama3.2-1b's bf16 dense-cache decode step (B 8, 32768 slots) on a fake
    (1, 4) mesh counts exactly the collectives the 4-card run counted."""
    assert _part(results, "decode")["counts"] == CARD_COUNTS


@pytest.mark.parametrize("arch", list(FAMILY_ARCHS.values()))
def test_two_probe_fit_equals_a_direct_trace(results, arch):
    """The fit through the probes at 1 and 2 units, at 3 units, equals a
    direct 3-unit trace in flops, bytes and collective moved bytes."""
    rec = _part(results, "probes")["fit"][arch]
    fit, direct = rec["fit"], rec["direct"]
    for get in (lambda r: r["flops"], lambda r: r["bytes_accessed"],
                lambda r: r["collectives"]["moved_bytes_per_device"]):
        assert get(fit) == pytest.approx(get(direct), rel=1e-9, abs=0), (fit, direct)


def test_inspector_rows_equal_the_probe(results):
    """``inspect_colls`` at units 1 lists as many calls, moving as many bytes,
    as the dry run's first probe of the same cell counted."""
    res = _part(results, "layout")
    cell = res["cell"]
    assert cell["ok"] and cell["world"] == 256, cell["error"]
    assert cell["memory"]["argument_size_in_bytes"] == sum(
        cell["argument_bytes_by_group"].values())
    probe = cell["extrapolated"]["probe"]
    assert res["inspect"]["rows"] == probe["coll_calls"][0] > 0
    assert res["inspect"]["moved"] == probe["coll"][0]


@pytest.mark.parametrize("single", [False, True])
def test_full_trace_and_fit_run_the_same_microbatches(results, single):
    """dbrx-smoke's train cell (4 microbatches in its profile) traced whole
    and fitted from its probes, with and without ``force_single_microbatch``:
    the fit and the full trace run the same microbatches, so at the smoke's
    2 layers (the second probe's depth) the fit is the full trace."""
    r = _part(results, "decode")["microbatches"][str(single)]
    assert r["ok"], r["error"]
    assert r["microbatches"] == (1 if single else 4)
    assert r["extrapolated"]["fit_over_full_trace_minus_1"] == {
        "flops": 0.0, "bytes_accessed": 0.0, "collective_moved_bytes": 0.0,
        "temp_size_in_bytes": 0.0}


def test_long_500k_of_a_full_attention_arch_is_skipped(results):
    skip = _part(results, "layout")["skip"]
    reason = "full-attention arch: long_500k inapplicable"
    assert skip["ok"] and skip["skipped"] and skip["reason"] == reason
    assert reason in (ROOT / "src/repro/launch/dryrun.py").read_text()


def test_fake_world_refuses_a_group_and_leaves_none(results):
    res = _part(results, "layout")
    assert res["refused"] and "gloo" in res["refused"], res["refused"]
    assert res["inside"] == 4 and res["after"] is False


if __name__ == "__main__":
    torch.set_num_threads(1)
    sys.path.insert(0, str(ROOT / "src"))
    {"layout": part_layout, "decode": part_decode, "probes": part_probes}[sys.argv[1]](
        Path(sys.argv[2]))
