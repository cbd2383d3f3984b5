"""Multi-pod dry run of the port: trace one step of every (arch x shape x
mesh) cell as rank 0 of a fake world of 256 / 512 ranks, and record its
memory, flops, bytes and collective bytes a rank (the port of
``repro.launch.dryrun``).

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all --mesh both
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape train_4k \\
      --mesh single

The reference lowers and compiles each cell on 512 forced host devices and
reads XLA's analyses of the compiled HLO. The port has no HLO, so it runs the
step itself, as one rank, with nothing allocated:

* the world is ``torch.distributed``'s ``"fake"`` backend at rank 0 of
  ``world`` ranks (``fake_world``): every collective returns at once and
  moves nothing, so one process stands for the whole mesh;
* every tensor is a fake tensor (``FakeTensorMode``): shapes, dtypes and
  DTensor placements without storage. Parameters, moments, caches and inputs
  are the port's own leaves, laid onto the mesh by
  ``core.distributed.tree_distribute`` / ``optim.adamw_init(mesh=)`` as a
  real run lays them;
* one step of the cell runs under a dispatch mode (``StepTracer``) that sees
  the aten ops on rank 0's local tensors, inside DTensor's dispatch and the
  block maps' ``local_map`` bodies alike, in the forward and the backward.

Where the figures come from: every op of a traced step pays FakeTensorMode's
dispatch on the host, and a full-depth step runs up to millions of ops
(minutes a cell for mamba2-780m's prefill_32k or llama-3.2-vision-90b's
train_4k, PERF.md §6 PR 36), so by default a
cell's figures come from the reference's fit, ``metric(L) = a + L b``
through probes at depth units 1 and 2 (``cfg_with_depth_units``), extended to
every figure (``fit_tree``): exact wherever a layer's cost is the same at
every depth, as a direct 3-unit trace shows for every family. The probes run
the cell's microbatches; the ``extrapolated`` record keeps the reference's
one-microbatch probes. ``--full`` traces the step at full depth too and
takes the figures from it, with the fit's distance beside them. The
arguments are always built at full size.

What the step runs is the plain path: a fake CPU tensor takes the plain
versions of the kernels (``kernels.ops._want_kernel``), as the reference's
host devices lower the jnp twins of its Pallas kernels
(``repro.kernels.ops._want_pallas`` is false off a TPU). So ``flops`` and
``bytes_accessed`` count the plain versions' aten ops, and
``temp_size_in_bytes`` is the plain path's peak: its attention is blocked,
with memory O(Tq * 512) (``kernels.flash_attention``).

Each cell's JSON has the reference's keys:
  ``memory``: ``argument_size_in_bytes`` (rank 0's local bytes of the
    params, moments, caches and inputs the step is given, from the DTensors'
    local tensors; a quantized leaf's q and scale buffers both count; the
    inputs are whole on every rank, as the port's steps take them;
    ``argument_bytes_by_group`` splits it), ``output_size_in_bytes`` (the
    same of the step's outputs), ``alias_size_in_bytes`` (the outputs that
    are arguments' storage: what the step updates in place) and
    ``temp_size_in_bytes`` (the peak of the live bytes the step allocated
    beside its arguments);
  ``flops``: the flops of rank 0's ops by ``torch.utils.flop_counter``'s
    formulas (``cost_keys`` by op);
  ``bytes_accessed``: the sum, over the traced aten ops that are not views,
    of the bytes their inputs and outputs address (a broadcast operand's
    once): what an eager step reads and writes;
  ``collectives``: ``collective_stats``' shape, with ``moved_bytes_per_device``
    from the reference's ring factors on each call's own group size, applied
    to the bytes the rank hands the op. For a reduce-scatter that is the
    whole unscattered buffer, so its term is the ring's own, ``input * (n -
    1) / n`` = ``shard * (n - 1)``; the reference applies the factor to the
    HLO result, the shard, and so counts ``shard * (n - 1) / n``, n times
    less (a departure: the port's reduce-scatter ``moved_bytes`` are n times
    the reference's; its ``result_bytes`` are the shard's, as the
    reference's; the other kinds agree). The reference's ``moved_bytes_tpu``
    halves f32 collectives that XLA:CPU legalised from bf16; the port's
    collectives run in their own dtype, so the key has no counterpart and is
    left out;
  ``extrapolated``: the reference's record of its fit.
``--save-hlo`` writes the port's nearest record of the compiled module, the
full trace's op list, as ``{cell}.ops.txt``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, List, Optional, Sequence, Union

import torch

from repro_torch.configs.shapes import SHAPES, Shape, cell_is_applicable
from repro_torch.core.distributed import (
    distribute,
    is_dtensor,
    is_spec,
    local_tensor,
    q_shapes,
    tree_distribute,
)
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.launch.mesh import _mesh, make_production_mesh
from repro_torch.launch.sharding import rules_for
from repro_torch.models import ARCH_IDS, build_model, count_params, get_config
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.serving import make_prefill, make_serve_step
from repro_torch.train import TrainProfile, make_train_step

# ------------------------------------------------------------------------------------
# per-arch training profiles (the reference's: microbatching and 8-bit optimizer
# state where memory demands it)
# ------------------------------------------------------------------------------------
TRAIN_PROFILES = {
    "kimi-k2-1t-a32b": dict(
        opt=AdamWConfig(int8_state=True, state_block=64),
        profile=TrainProfile(num_microbatches=8, accum_dtype=torch.bfloat16),
    ),
    "llama-3.2-vision-90b": dict(
        opt=AdamWConfig(), profile=TrainProfile(num_microbatches=8)
    ),
    "dbrx-132b": dict(
        opt=AdamWConfig(int8_state=True, state_block=64),
        profile=TrainProfile(num_microbatches=4),
    ),
    "_default": dict(opt=AdamWConfig(), profile=TrainProfile(num_microbatches=1)),
}

SKIP_REASON = "full-attention arch: long_500k inapplicable"


def train_profile_for(arch: str):
    d = TRAIN_PROFILES.get(arch, TRAIN_PROFILES["_default"])
    return d["opt"], d["profile"]


# ------------------------------------------------------------------------------------
# the fake world and its meshes
# ------------------------------------------------------------------------------------
@contextlib.contextmanager
def fake_world(world: int):
    """Rank 0 of ``world`` ranks on the ``"fake"`` backend, destroyed on exit.
    Refuses where a process group exists: a dry run never runs inside a real
    group, and leaves no default group behind."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        raise RuntimeError(
            f"a process group exists (backend {dist.get_backend()}, world "
            f"{dist.get_world_size()}): the dry run opens its own fake group and runs in no "
            "other")
    try:
        from torch.testing._internal.distributed.fake_pg import FakeStore
    except ImportError as e:  # the fake backend's store moved or went
        raise RuntimeError(f"torch {torch.__version__} has no fake process group "
                           f"(torch.testing._internal.distributed.fake_pg): {e}") from e
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield world
    finally:
        dist.destroy_process_group()


MESH_NAMES = {2: ("data", "model"), 3: ("pod", "data", "model")}


def mesh_name(multi_pod: bool, mesh_shape: Optional[Sequence[int]] = None) -> str:
    if mesh_shape is not None:
        return "mesh" + "x".join(str(n) for n in mesh_shape)
    return "pod2x16x16" if multi_pod else "pod16x16"


def world_of(multi_pod: bool, mesh_shape: Optional[Sequence[int]] = None) -> int:
    return math.prod(mesh_shape) if mesh_shape is not None else (512 if multi_pod else 256)


def make_mesh(multi_pod: bool, mesh_shape: Optional[Sequence[int]] = None):
    """The production mesh ((16, 16) ("data", "model"), or (2, 16, 16) with
    "pod" first), or a ``mesh_shape`` of 2 or 3 dims named alike, over the
    fake world's CPU ranks."""
    if mesh_shape is None:
        return make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    if len(mesh_shape) not in MESH_NAMES:
        raise ValueError(f"a mesh of {len(mesh_shape)} dims: the rules name 2 or 3")
    return _mesh(tuple(mesh_shape), MESH_NAMES[len(mesh_shape)], "cpu")


# ------------------------------------------------------------------------------------
# depth probes: the reference fits metric(L) = a + L b from depth units 1 and 2
# ------------------------------------------------------------------------------------
def cfg_with_depth_units(cfg, units: int):
    if cfg.family == "hybrid":
        return dataclasses.replace(cfg, n_layers=len(cfg.pattern) * units)
    if cfg.family == "vlm":
        return dataclasses.replace(cfg, n_layers=5 * units)
    if cfg.family == "encdec":
        return dataclasses.replace(cfg, n_layers=units, n_enc_layers=units)
    return dataclasses.replace(cfg, n_layers=units)


def depth_units(cfg) -> float:
    if cfg.family == "hybrid":
        return cfg.n_layers / len(cfg.pattern)  # fractional remainder approximated
    if cfg.family == "vlm":
        return cfg.n_layers / 5
    return float(cfg.n_layers)


def fit_depth(m1: float, m2: float, units: float) -> float:
    """The reference's fit through the probes at 1 and 2 units, at ``units``."""
    slope = m2 - m1
    return max(m1 - slope, 0.0) + units * slope


# ------------------------------------------------------------------------------------
# collectives: the reference's table, on the port's op names
# ------------------------------------------------------------------------------------
COLL_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")
# c10d's process-group ops (dist.* in the block maps) and the functional ones
# (DTensor's redistributions), by the reference's op names
COLL_KIND = {
    **dict.fromkeys(("allreduce_", "allreduce_coalesced_", "all_reduce", "all_reduce_",
                     "all_reduce_coalesced", "all_reduce_coalesced_"), "all-reduce"),
    **dict.fromkeys(("allgather_", "_allgather_base_", "allgather_coalesced_",
                     "allgather_into_tensor_coalesced_", "all_gather_into_tensor",
                     "all_gather_into_tensor_out", "all_gather_into_tensor_coalesced"),
                    "all-gather"),
    **dict.fromkeys(("reduce_scatter_", "_reduce_scatter_base_",
                     "reduce_scatter_tensor_coalesced_", "reduce_scatter_tensor",
                     "reduce_scatter_tensor_coalesced"), "reduce-scatter"),
    **dict.fromkeys(("alltoall_", "alltoall_base_", "all_to_all_single"), "all-to-all"),
    **dict.fromkeys(("send", "recv_", "recv_any_source_"), "collective-permute"),
}
# per-device bytes over links, ring estimates, of what the rank hands the op
RING_FACTOR = {
    "all-gather": lambda n: n - 1,  # the input is the local shard
    # the input is the whole buffer: shard * (n - 1), n times the reference's
    # term, which it takes from the result shard (the module docstring)
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-reduce": lambda n: 2 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1,
}
RESULT_FACTOR = {"all-gather": lambda n: n, "reduce-scatter": lambda n: 1 / n}


def collective_kind(name: str) -> str:
    if name not in COLL_KIND:
        raise ValueError(f"collective {name!r} has no entry in the dry run's table (COLL_KIND)")
    return COLL_KIND[name]


def collective_stats(records: Sequence[Dict[str, Any]]):
    """Per-op count, result bytes and moved bytes of ``CollectiveCounter``
    records (``op``, ``input_bytes``, ``dtype``, ``group_size``), the
    reference's ``collective_stats`` without ``moved_bytes_tpu``."""
    per_op = {k: {"count": 0, "result_bytes": 0, "moved_bytes": 0.0} for k in COLL_OPS}
    f32_moved = 0.0
    for r in records:
        kind, n, b = collective_kind(r["op"]), max(r["group_size"], 1), r["input_bytes"]
        moved = b * RING_FACTOR[kind](n)
        d = per_op[kind]
        d["count"] += 1
        d["result_bytes"] += int(b * RESULT_FACTOR.get(kind, lambda n: 1)(n))
        d["moved_bytes"] += moved
        if r["dtype"] == "torch.float32":
            f32_moved += moved
    return {"per_op": per_op,
            "moved_bytes_per_device": sum(d["moved_bytes"] for d in per_op.values()),
            "moved_bytes_f32": f32_moved}


# ------------------------------------------------------------------------------------
# the tracer: rank 0's aten ops, flops, bytes and live memory
# ------------------------------------------------------------------------------------
def _flat(xs) -> List[Any]:
    out = []
    for x in xs:
        if isinstance(x, (list, tuple)):
            out.extend(_flat(x))
        else:
            out.append(x)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _touched_bytes(t: torch.Tensor) -> int:
    """The bytes of the elements ``t`` addresses: a broadcast dim (stride 0)
    reads its elements once. ``torch.matmul`` folds a (B, 1, K) x (K, N)
    product into one mm or expands the weight into a bmm by the operands'
    strides, which a fake tensor need not share with the real one: both
    touch the same bytes."""
    return math.prod(n for n, st in zip(t.shape, t.stride()) if st != 0) * t.element_size()


NO_BYTES = ("empty", "empty_like", "empty_strided", "_unsafe_view", "lift_fresh")


class StepTracer:
    """A dispatch mode over one step on rank 0's local tensors. An op on
    DTensors is handed back to DTensor (the mode returns NotImplemented), so
    what the mode counts are the ops DTensor then runs on the local tensors,
    its redistributions' collectives among them, and the ops of the
    ``local_map`` bodies. The ops DTensor's sharding propagation runs on
    global-shape fake tensors to learn an output's shape (its
    ``ShardingPropagator._propagate_tensor_meta_non_cached``, on a cache miss)
    are not rank 0's work, and are not counted.

    ``flops`` / ``flops_by_op``: ``torch.utils.flop_counter``'s formulas;
    ``bytes_accessed``: inputs' and outputs' bytes of the non-view aten ops;
    ``collectives``: ``CollectiveCounter``'s per-call records; ``peak_temp``:
    the peak of the live bytes of the storages the step allocated (those of
    ``args`` not among them); ``ops``: the op list, kept with ``keep_ops``."""

    def __init__(self, args=(), keep_ops: bool = False):
        from torch.utils.flop_counter import flop_registry

        from repro_torch.core.distributed import CollectiveCounter

        self.registry = flop_registry
        self.flops = 0
        self.flops_by_op: Dict[str, int] = {}
        self.bytes_accessed = 0
        self.keep_ops = keep_ops
        self.ops: List[str] = []
        self.counter = CollectiveCounter(record=True, origin_skip=("launch/dryrun.py",))
        self.live = self.peak_temp = 0
        self._tracked: Dict[int, int] = {}
        self._args = {id(t.untyped_storage()) for t in leaf_tensors(args)}
        self._mode = None
        self._paused = 0
        self._saved = None

    @property
    def collectives(self) -> List[Dict[str, Any]]:
        return self.counter.records

    def _track(self, t: torch.Tensor) -> None:
        st = t.untyped_storage()
        key = id(st)
        if key in self._args or key in self._tracked:
            return
        n = st.nbytes()
        self._tracked[key] = n
        self.live += n
        self.peak_temp = max(self.peak_temp, self.live)
        weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        self.live -= self._tracked.pop(key, 0)

    def seen(self, func, args, kwargs, out) -> None:
        if self._paused:
            return
        if func.namespace in self.counter.NAMESPACES:
            self.counter.seen(func, args, kwargs)
            return
        if func.namespace != "aten":
            return
        ins = [a for a in _flat(list(args) + list(kwargs.values())) if isinstance(a, torch.Tensor)]
        outs = [o for o in _flat(out if isinstance(out, (list, tuple)) else [out])
                if isinstance(o, torch.Tensor)]
        name = func._schema.name.split("::")[-1]
        packet = func._overloadpacket
        if packet in self.registry:
            n = int(self.registry[packet](*args, **kwargs, out_val=out))
            self.flops += n
            self.flops_by_op[name] = self.flops_by_op.get(name, 0) + n
        if not func.is_view and name not in NO_BYTES:
            self.bytes_accessed += sum(_touched_bytes(t) for t in ins + outs)
        for t in outs:
            self._track(t)
        if self.keep_ops:
            self.ops.append(f"{func} {[tuple(t.shape) for t in ins]} -> "
                            f"{[(tuple(t.shape), str(t.dtype)) for t in outs]}")

    def __enter__(self):
        from torch.distributed.tensor import DTensor
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
        from torch.utils._python_dispatch import TorchDispatchMode

        tracer = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                if any(issubclass(t, DTensor) for t in types):
                    return NotImplemented  # DTensor runs it; the mode sees its local ops
                out = func(*args, **kwargs)
                tracer.seen(func, args, kwargs, out)
                return out

        name = "_propagate_tensor_meta_non_cached"
        orig = getattr(ShardingPropagator, name, None)
        if orig is None:
            raise RuntimeError(f"torch {torch.__version__}: DTensor's ShardingPropagator has no "
                               f"{name}; the tracer cannot tell its shape propagation apart")

        def paused(prop, *a, **kw):
            tracer._paused += 1
            try:
                return orig(prop, *a, **kw)
            finally:
                tracer._paused -= 1

        self._saved = (ShardingPropagator, name, orig)
        setattr(ShardingPropagator, name, paused)
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        setattr(*self._saved)
        self._saved = None
        return False


def leaf_tensors(tree) -> List[torch.Tensor]:
    """Every tensor of a tree (lists, tuples, dicts), a DTensor as its local
    tensor."""
    out = []
    for x in tree_leaves(tree):
        if isinstance(x, torch.Tensor):
            out.append(local_tensor(x) if is_dtensor(x) else x)
    return out


def local_bytes(tree) -> int:
    """Rank 0's bytes of a tree: each leaf's local tensor, each storage once."""
    seen, total = set(), 0
    for t in leaf_tensors(tree):
        key = (id(t.untyped_storage()), t.storage_offset(), tuple(t.shape))
        if key not in seen:
            seen.add(key)
            total += _nbytes(t)
    return total


# ------------------------------------------------------------------------------------
# cells
# ------------------------------------------------------------------------------------
def _zeros(spec):
    """A spec's zeroed leaf: its tensor, or a quantized spec's {"q", "scale"}."""
    if getattr(spec, "quant", None) is not None:
        qs, ss = q_shapes(spec)
        return {"q": torch.zeros(qs, dtype=torch.int8), "scale": torch.zeros(ss)}
    return torch.zeros(spec.shape, dtype=spec.dtype)


def _params(model, mesh, rules):
    specs = model.param_specs()
    return tree_distribute(tree_map(_zeros, specs, is_leaf=is_spec), specs, mesh, rules)


def _caches(model, batch: int, seq: int, mesh, rules):
    """The decode caches of ``model.cache_specs``, each with its leading layer
    dim, laid out by the rules' cache axes ("layers" first), as a sharded
    prefill returns them."""
    from repro_torch.models.transformer import block_program

    def entry(specs, n):
        def leaf(s):
            shape = (n,) + tuple(s.shape)
            return distribute(torch.zeros(shape, dtype=s.dtype), mesh,
                              rules.placements(("layers",) + s.axes, shape, mesh))

        return tree_map(leaf, specs, is_leaf=is_spec)

    return [entry(specs, n) for specs, (_, n) in zip(model.cache_specs(batch, seq),
                                                     block_program(model.cfg))]


def input_specs(cfg, shape: Shape) -> Dict[str, torch.Tensor]:
    """The step's inputs, whole, as the port's steps take them on every rank:
    int32 tokens ((B, T + 1) to train, (B, T) to prefill, (B,) to decode) and
    whisper's frames or the vision model's image embeddings where the step
    encodes them."""
    b, s = shape.batch, shape.seq
    tokens = {"train": (b, s + 1), "prefill": (b, s), "decode": (b,)}[shape.kind]
    specs = {"tokens": torch.zeros(tokens, dtype=torch.int32)}
    if cfg.family == "encdec" and shape.kind != "decode":
        specs["frames"] = torch.zeros((b, cfg.enc_seq, cfg.d_model), dtype=cfg.param_dtype)
    if cfg.family == "vlm" and shape.kind != "decode":
        specs["image_embeds"] = torch.zeros((b, cfg.n_img_tokens, cfg.d_model),
                                            dtype=cfg.param_dtype)
    return specs


def shape_of(shape: Union[str, Shape]) -> Shape:
    return SHAPES[shape] if isinstance(shape, str) else shape


def build_cell(arch: str, shape: Union[str, Shape], mesh, *, seq_shard: bool = False,
               remat_policy=None, extra_rules=None, cfg_override=None,
               force_single_microbatch: bool = False, quantized: bool = False):
    """-> (fn, args, groups) for one cell: ``fn(*args)`` runs its step, and
    ``groups`` names what each argument is ("params", "moments", "caches",
    "inputs"). Call it inside a world that ``mesh`` spans; under
    ``FakeTensorMode`` nothing is allocated."""
    cfg = cfg_override if cfg_override is not None else get_config(arch)
    shape = shape_of(shape)
    quantized = quantized and shape.kind != "train"
    rules = rules_for(cfg, shape.kind, seq_shard=seq_shard, quantized=quantized)
    if extra_rules:
        rules = dataclasses.replace(rules, rules={**rules.rules, **extra_rules})
    model = build_model(cfg, quantized=quantized, device="cpu")
    inputs = input_specs(cfg, shape)

    if shape.kind == "train":
        opt, profile = train_profile_for(arch)
        if remat_policy is not None:
            profile = dataclasses.replace(profile, remat_policy=remat_policy)
        if force_single_microbatch:
            profile = dataclasses.replace(profile, num_microbatches=1)
        step, _, sspecs = make_train_step(model, opt, profile, mesh=mesh, rules=rules)
        opt_state = adamw_init(sspecs, "cpu", mesh, rules)
        return step, (_params(model, mesh, rules), opt_state, inputs), \
            ("params", "moments", "inputs")

    params = _params(model, mesh, rules)
    if shape.kind == "prefill":
        prefill = make_prefill(model, mesh, rules, max_len=shape.seq)
        tokens = inputs.pop("tokens")

        def fn(params, tokens, binputs=None):
            return prefill(params, tokens, binputs)

        return fn, (params, tokens, inputs or None), ("params", "inputs", "inputs")

    # decode: one token a row at the cache's last slot
    serve = make_serve_step(model, mesh, rules)
    caches = _caches(model, shape.batch, shape.seq, mesh, rules)
    return serve, (params, caches, inputs["tokens"], shape.seq - 1), \
        ("params", "caches", "inputs", "inputs")


def argument_bytes(fn_args, groups) -> Dict[str, int]:
    """Rank 0's local bytes of a cell's arguments, by group."""
    out: Dict[str, int] = {}
    for g, a in zip(groups, fn_args):
        out[g] = out.get(g, 0) + local_bytes(a)
    return out


def cell_arguments(arch: str, shape, mesh, **build_kw) -> Dict[str, int]:
    """A cell's argument bytes by group, built at full size under
    ``FakeTensorMode``, with no step run."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        _, args, groups = build_cell(arch, shape, mesh, **build_kw)
        return argument_bytes(args, groups)


def trace_cell(arch: str, shape, mesh, *, keep_ops: bool = False, **build_kw):
    """Build and run one step of a cell under ``FakeTensorMode`` and a
    ``StepTracer``. -> (tracer, {the figures of ``figures``}, argument bytes
    by group)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(allow_non_fake_inputs=True):
        fn, args, groups = build_cell(arch, shape, mesh, **build_kw)
        tracer = StepTracer(args, keep_ops=keep_ops)
        with tracer:
            out = fn(*args)
        arg_storages = {id(t.untyped_storage()) for t in leaf_tensors(args)}
        alias = sum(_nbytes(t) for t in leaf_tensors(out)
                    if id(t.untyped_storage()) in arg_storages)
        return tracer, figures(tracer, local_bytes(out), alias), argument_bytes(args, groups)


def figures(tracer: StepTracer, output_bytes: int, alias_bytes: int) -> Dict[str, Any]:
    """The cell record's measured keys from one traced step."""
    return {
        "flops": float(tracer.flops),
        "bytes_accessed": float(tracer.bytes_accessed),
        "cost_keys": {k: float(v) for k, v in sorted(tracer.flops_by_op.items())},
        "memory": {"output_size_in_bytes": output_bytes,
                   "temp_size_in_bytes": tracer.peak_temp,
                   "alias_size_in_bytes": alias_bytes},
        "collectives": collective_stats(tracer.collectives),
        "collective_calls": {"calls": dict(tracer.counter.calls),
                             "input_bytes": dict(tracer.counter.bytes)},
    }


def fit_tree(m1, m2, units: float):
    """``fit_depth`` on every number of two probes' records (a key one of
    them lacks counts 0)."""
    if isinstance(m1, dict) or isinstance(m2, dict):
        m1, m2 = m1 or {}, m2 or {}
        return {k: fit_tree(m1.get(k), m2.get(k), units) for k in {**m1, **m2}}
    return fit_depth(float(m1 or 0), float(m2 or 0), units)


def probe(arch: str, shape, mesh, units: int, cfg=None, one_microbatch: bool = True,
          **build_kw) -> Dict[str, Any]:
    """The figures of one probe: ``arch``'s config (or ``cfg``) cut to
    ``units`` depth units, one microbatch (the reference's), or the profile's
    microbatches without ``one_microbatch``."""
    cfg = cfg_with_depth_units(cfg if cfg is not None else get_config(arch), units)
    return trace_cell(arch, shape, mesh, cfg_override=cfg, force_single_microbatch=one_microbatch,
                      **build_kw)[1]


def fit_probes(arch: str, shape, mesh, cfg, one_microbatch: bool = True, **build_kw):
    """The probes at depth units 1 and 2 and every figure fitted to ``cfg``'s
    depth: (p1, p2, fitted)."""
    p1, p2 = (probe(arch, shape, mesh, u, cfg=cfg, one_microbatch=one_microbatch, **build_kw)
              for u in (1, 2))
    return p1, p2, fit_tree(p1, p2, depth_units(cfg))


def extrapolated_metrics(arch: str, shape, mesh, cfg=None, **build_kw):
    """The reference's ``extrapolated`` record: its fit from one-microbatch
    probes at depth units 1 and 2 of ``arch``'s config (or ``cfg``). ->
    (the record, every figure fitted)."""
    cfg = cfg if cfg is not None else get_config(arch)
    p1, p2, fitted = fit_probes(arch, shape, mesh, cfg, **build_kw)
    return {
        "flops_per_device": fitted["flops"],
        "bytes_per_device": fitted["bytes_accessed"],
        "collective_moved_bytes_per_device": fitted["collectives"]["moved_bytes_per_device"],
        "probe": {"units": [1, 2], "flops": [p1["flops"], p2["flops"]],
                  "bytes": [p1["bytes_accessed"], p2["bytes_accessed"]],
                  "coll": [p["collectives"]["moved_bytes_per_device"] for p in (p1, p2)],
                  "coll_calls": [sum(p["collective_calls"]["calls"].values()) for p in (p1, p2)],
                  "depth_units": depth_units(cfg)},
    }, fitted


def fit_distance(fitted: Dict[str, Any], full: Dict[str, Any]) -> Dict[str, Optional[float]]:
    """fit / full - 1 of the flops, bytes, collective moved bytes and temp
    bytes."""
    def pick(r):
        return {"flops": r["flops"], "bytes_accessed": r["bytes_accessed"],
                "collective_moved_bytes": r["collectives"]["moved_bytes_per_device"],
                "temp_size_in_bytes": r["memory"]["temp_size_in_bytes"]}

    got, want = pick(fitted), pick(full)
    return {k: (got[k] / v - 1.0) if v else None for k, v in want.items()}


def params_of(cfg) -> Dict[str, int]:
    return {"params_total": count_params(cfg),
            "params_active": count_params(cfg, active_only=True)}


def run_cell(arch: str, shape_name: Union[str, Shape], multi_pod: bool, out_dir: Path, *,
             save_hlo: bool = False, tag: str = "", full: bool = False,
             mesh_shape: Optional[Sequence[int]] = None, **build_kw):
    """One cell as rank 0 of its fake world -> ``{arch}__{shape}__{mesh}[__tag].json``
    in ``out_dir``. The arguments are built at full size (their bytes exact);
    the figures come from the two probes' fit (``figures_from: "probes"``), as
    the reference's do, or with ``full`` from one trace of the step at full
    depth, the probes beside it. ``mesh_shape``: another mesh than the
    production one (2 or 3 dims)."""
    shape = shape_of(shape_name)
    mname = mesh_name(multi_pod, mesh_shape)
    cell_id = f"{arch}__{shape.name}__{mname}" + (f"__{tag}" if tag else "")
    out_dir = Path(out_dir)
    out_path = out_dir / f"{cell_id}.json"
    world = world_of(multi_pod, mesh_shape)
    t0 = time.time()
    result = {"arch": arch, "shape": shape.name, "mesh": mname, "tag": tag, "ok": False}
    try:
        cfg = build_kw.get("cfg_override") or get_config(arch)
        if not cell_is_applicable(cfg, shape.name):
            result.update(ok=True, skipped=True, reason=SKIP_REASON)
            out_path.write_text(json.dumps(result, indent=1))
            print(f"[dryrun] SKIP {cell_id}", flush=True)
            return result
        seconds = {}
        kw = {k: v for k, v in build_kw.items()
              if k not in ("cfg_override", "force_single_microbatch")}
        single = bool(build_kw.get("force_single_microbatch"))
        microbatches = (train_profile_for(arch)[1].num_microbatches
                        if shape.kind == "train" and not single else 1)
        with fake_world(world):
            mesh = make_mesh(multi_pod, mesh_shape)
            if full:
                tracer, got, args = trace_cell(arch, shape, mesh, keep_ops=save_hlo, **build_kw)
                seconds["trace"] = round(time.time() - t0, 1)
                if save_hlo:
                    (out_dir / f"{cell_id}.ops.txt").write_text("\n".join(tracer.ops) + "\n")
                del tracer
            else:
                args = cell_arguments(arch, shape, mesh, **build_kw)
            t1 = time.time()
            result["extrapolated"], fitted = extrapolated_metrics(arch, shape, mesh, cfg, **kw)
            if microbatches > 1:  # the cell's step runs them; the reference's probes one
                fitted = fit_probes(arch, shape, mesh, cfg, one_microbatch=False, **kw)[2]
            if full:
                result["extrapolated"]["fit_over_full_trace_minus_1"] = fit_distance(fitted, got)
            seconds["probes"] = round(time.time() - t1, 1)
        got = got if full else fitted
        seconds["total"] = round(time.time() - t0, 1)
        result.update(ok=True, skipped=False, world=world, mesh_shape=list(mesh.shape),
                      figures_from="full_trace" if full else "probes", microbatches=microbatches,
                      seconds=seconds,
                      **got, argument_bytes_by_group=args, **params_of(cfg))
        result["memory"] = {"argument_size_in_bytes": sum(args.values()), **got["memory"]}
    except Exception as e:
        result.update(ok=False, error=str(e)[:2000], traceback=traceback.format_exc()[-4000:])
        print(f"[dryrun] FAIL {cell_id}: {e}", flush=True)
    out_path.write_text(json.dumps(result, indent=1))
    if result.get("ok") and not result.get("skipped"):
        print(f"[dryrun] OK   {cell_id} {result['figures_from']} seconds={result['seconds']} "
              f"flops={result['flops']:.3g} "
              f"coll={result['collectives']['moved_bytes_per_device']:.3g}B "
              f"args={result['memory']['argument_size_in_bytes']:.3g}B", flush=True)
    return result


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--mesh-shape", default=None,
                    help="another mesh than the production one, e.g. 2x4 (data x model) or "
                         "2x2x2 (pod x data x model); overrides --mesh")
    ap.add_argument("--batch", type=int, default=None, help="the shape's batch, overridden")
    ap.add_argument("--seq", type=int, default=None, help="the shape's sequence, overridden")
    ap.add_argument("--out", default="artifacts/dryrun_torch")
    ap.add_argument("--save-hlo", action="store_true",
                    help="write the full trace's op list, {cell}.ops.txt (implies --full)")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--tag", default="")
    ap.add_argument("--seq-shard", action="store_true")
    ap.add_argument("--quantized", action="store_true")
    ap.add_argument("--remat-policy", default=None)
    ap.add_argument("--full", action="store_true",
                    help="trace the step at full depth too, and take the figures from it")
    args = ap.parse_args(argv)

    archs = ARCH_IDS if args.arch == "all" else args.arch.split(",")
    shapes = [SHAPES[s] for s in (list(SHAPES) if args.shape == "all" else args.shape.split(","))]
    if args.batch is not None or args.seq is not None:
        shapes = [dataclasses.replace(s, name=f"{s.name}_b{b}_s{t}", batch=b, seq=t)
                  for s in shapes for b, t in [(args.batch or s.batch, args.seq or s.seq)]]
    mesh_shape = (tuple(int(n) for n in args.mesh_shape.split("x"))
                  if args.mesh_shape else None)
    meshes = ([False] if mesh_shape else
              {"single": [False], "multi": [True], "both": [False, True]}[args.mesh])
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    n_fail, t0 = 0, time.time()
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                cell = f"{arch}__{shape.name}__{mesh_name(mp, mesh_shape)}" + \
                    (f"__{args.tag}" if args.tag else "")
                if args.skip_existing and (out_dir / f"{cell}.json").exists():
                    prev = json.loads((out_dir / f"{cell}.json").read_text())
                    if prev.get("ok"):
                        print(f"[dryrun] CACHED {cell}")
                        continue
                r = run_cell(arch, shape, mp, out_dir, save_hlo=args.save_hlo, tag=args.tag,
                             full=args.full or args.save_hlo, mesh_shape=mesh_shape,
                             seq_shard=args.seq_shard, remat_policy=args.remat_policy,
                             quantized=args.quantized)
                n_fail += 0 if r.get("ok") else 1
    print(f"[dryrun] done in {time.time() - t0:.1f}s, {n_fail} failures", flush=True)
    raise SystemExit(1 if n_fail else 0)


if __name__ == "__main__":
    main()
