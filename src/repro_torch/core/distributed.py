"""DistributedLayout and ShardingRules: the paper's LayoutMapping promoted to
a mesh of ranks (the port of ``repro.core.distributed``), on
``torch.distributed``'s ``DeviceMesh`` and ``DTensor``.

Sharding is a layout mapping: a strided-block map from the logical
multi-index domain onto (device coordinates) x (local offsets).
``DistributedLayout`` is that map as a ``LayoutMapping``, so the paper's
Table I properties apply to it, with the reference's geometry exactly.
``ShardingRules`` binds logical axis names to mesh axes (the per-(arch x
shape) policy, ``launch.sharding``); ``placements`` turns a binding into one
DTensor ``Placement`` per mesh dim, where the reference built a
``PartitionSpec``. Every parameter spec (``models.layers.ParamSpec``) carries
its logical axes, so a tree of specs gives a tree of placements
(``tree_shardings``) and a tree of tensors built alike on every rank is laid
onto a mesh by ``tree_distribute``.

Also here: the collectives ``local_map`` bodies call with the gradients
they need (``group_sum``, ``group_mean``, ``group_max``), a counter of the
collectives a step runs (``CollectiveCounter``), and, re-exported from
``core.packing`` under the reference's module name, ``quantize_array`` /
``dequantize_array`` and the int4 packers.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import torch

from .extents import Extents
from .layouts import LayoutError, LayoutMapping, _row_major_strides
from .packing import (  # noqa: F401  (re-exported under the reference's module name)
    as_int8_bits,
    dequantize_array,
    pack_int4_adjacent,
    pack_int4_splithalf,
    quantize_array,
    signed_nibble,
    unpack_int4_adjacent,
    unpack_int4_splithalf,
)
from .tree import tree_leaves, tree_map

AxisBinding = Union[None, str, Tuple[str, ...]]


# ---------------------------------------------------------------------------------
# DistributedLayout: a LayoutMapping over (devices x local memory)
# ---------------------------------------------------------------------------------
def _axis_names(b: AxisBinding) -> Tuple[str, ...]:
    if b is None:
        return ()
    return (b,) if isinstance(b, str) else tuple(b)


@dataclasses.dataclass(frozen=True)
class DistributedLayout(LayoutMapping):
    """Block map: logical index -> (device coordinate per sharded dim, local
    offset), the reference's geometry. ``mesh_axes[r]`` names the mesh
    axis or axes dim r is sharded over (None: replicated in that dim);
    ``axis_sizes`` maps an axis name to its size. The codomain is
    device_id * local_span + local_offset, a single-offset LayoutMapping:
    unique always; contiguous iff every sharded dim divides evenly and the
    sharded dims are a prefix of the dim order; strided iff nothing is
    sharded, or only dim 0, evenly."""

    extents: Extents
    mesh_axes: Tuple[AxisBinding, ...]
    axis_sizes: Dict[str, int]

    def __post_init__(self):
        if len(self.mesh_axes) != self.extents.rank:
            raise TypeError("mesh_axes rank mismatch")

    def dim_shards(self, r: int) -> int:
        return math.prod(self.axis_sizes[n] for n in _axis_names(self.mesh_axes[r]))

    def local_shape(self) -> Tuple[int, ...]:
        return tuple(-(-self.extents.extent(r) // self.dim_shards(r))
                     for r in range(self.extents.rank))

    def num_devices_used(self) -> int:
        return math.prod(self.dim_shards(r) for r in range(self.extents.rank))

    def local_span(self) -> int:
        return math.prod(self.local_shape())

    def __call__(self, *idx):
        return self.device_of(*idx) * self.local_span() + self.local_offset(*idx)

    def device_of(self, *idx):
        local = self.local_shape()
        dstr = _row_major_strides(tuple(self.dim_shards(r) for r in range(self.extents.rank)))
        dev = 0
        for r, i in enumerate(idx):
            dev = dev + (i // local[r]) * dstr[r]
        return dev

    def local_offset(self, *idx):
        local = self.local_shape()
        lstr = _row_major_strides(local)
        loc = 0
        for r, i in enumerate(idx):
            loc = loc + (i % local[r]) * lstr[r]
        return loc

    def required_span_size(self) -> int:
        return self.num_devices_used() * self.local_span()

    def is_unique(self) -> bool:
        return True

    @classmethod
    def is_always_unique(cls) -> bool:
        return True

    def is_contiguous(self) -> bool:
        if any(self.extents.extent(r) % self.dim_shards(r) for r in range(self.extents.rank)):
            return False
        sharded = [r for r in range(self.extents.rank) if self.dim_shards(r) > 1]
        return sharded == list(range(len(sharded)))

    def is_strided(self) -> bool:
        sharded = [r for r in range(self.extents.rank) if self.dim_shards(r) > 1]
        return not sharded or (sharded == [0]
                               and self.extents.extent(0) % self.dim_shards(0) == 0)

    def stride(self, r: int) -> int:
        """Defined only where the map is strided: the single sharded dim is
        the outermost and divides evenly, so a shard boundary's hop equals
        the step inside a shard, the local row-major stride."""
        if not self.is_strided():
            raise LayoutError("DistributedLayout is not globally strided here")
        return _row_major_strides(self.local_shape())[r]


# ---------------------------------------------------------------------------------
# meshes and placements
# ---------------------------------------------------------------------------------
def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` (by its dim names) or of a plain
    dict of them."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def _placements_of(binding: Sequence[AxisBinding], mesh) -> List[Any]:
    """One Placement per mesh dim: Shard(d) on each mesh dim that tensor dim
    d is bound to, Replicate() elsewhere. A dim bound to several axes must
    name them in the mesh's order (the major axis first, as DTensor splits a
    dim over mesh dims left to right); another order raises."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh.mesh_dim_names)
    out: List[Any] = [Replicate() for _ in names]
    for d, b in enumerate(binding):
        idx = [names.index(n) for n in _axis_names(b)]
        if idx != sorted(idx):
            raise ValueError(f"dim {d} is bound to {b}, in another order than the mesh's "
                             f"{tuple(names)}: DTensor would shard it in the mesh's order")
        for i in idx:
            out[i] = Shard(d)
    return out


def local_shape_and_offset(shape: Sequence[int], placements, mesh):
    """This rank's block of a tensor of ``shape`` laid out by ``placements``
    on ``mesh`` (every sharded dim divides evenly, as the rules guarantee):
    (local shape, global offset of its first element)."""
    from torch.distributed.tensor import Shard

    size, offset = list(shape), [0] * len(shape)
    coord = mesh.get_coordinate()
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            if size[p.dim] % n:
                raise ValueError(f"dim {p.dim} of {tuple(shape)} does not divide {n} ways")
            size[p.dim] //= n
            offset[p.dim] += coord[i] * size[p.dim]
    return tuple(size), tuple(offset)


# ---------------------------------------------------------------------------------
# collectives with the gradients a local_map body needs
# ---------------------------------------------------------------------------------
class _GroupSum(torch.autograd.Function):
    """The sum over a process group of each rank's ``x``. The output is the
    same on every rank (replicated), so each rank's incoming gradient is
    already the whole gradient of its own term: it passes through."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


class _Scale(torch.autograd.Function):
    """``x * scale`` whose backward scales by ``grad_scale``."""

    @staticmethod
    def forward(ctx, x, scale, grad_scale):
        ctx.grad_scale = grad_scale
        return x * scale

    @staticmethod
    def backward(ctx, g):
        return g * ctx.grad_scale, None, None


def _wide(groups):
    """The groups of more than one rank (a one-rank group's sum is x)."""
    import torch.distributed as dist

    return [g for g in groups if dist.get_world_size(g) > 1]


def group_sum(x: torch.Tensor, groups) -> torch.Tensor:
    """Sum ``x`` over each process group of ``groups`` (inside a
    ``local_map`` body whose output is declared replicated there)."""
    for g in _wide(groups):
        x = _GroupSum.apply(x, g)
    return x


def group_mean(x: torch.Tensor, groups, grad_scale: float = 1.0) -> torch.Tensor:
    """The mean of ``x`` over the ranks of ``groups`` (the reference's
    ``pmean``). Each rank's gradient is the output's over the rank count,
    times ``grad_scale``: below 1 where the same term is computed again on
    ranks whose gradients are then summed as a Partial."""
    import torch.distributed as dist

    n = math.prod(dist.get_world_size(g) for g in groups)
    return _Scale.apply(group_sum(x, groups), 1.0 / n, grad_scale / n)


def group_max(x: torch.Tensor, groups) -> torch.Tensor:
    """The elementwise max of ``x`` over each group (no gradient)."""
    import torch.distributed as dist

    x = x.detach().clone()
    for g in _wide(groups):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


class CollectiveCounter:
    """Counts the collectives run while it is entered, by op name: calls and
    the bytes of their input tensors (what each rank hands the collective).
    It sees both the process-group ops (``c10d``: ``dist.all_reduce`` in the
    port's ``local_map`` bodies) and the functional ones DTensor's
    redistributions run (``_c10d_functional``), in the forward and the
    backward, through a ``TorchDispatchMode``; every op pays a Python call
    while it is entered, so count one step, not a timed one."""

    NAMESPACES = ("c10d", "_c10d_functional")
    SKIP = ("wait_tensor", "barrier", "monitored_barrier")

    def __init__(self):
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self._mode = None

    def _seen(self, func, args, kwargs) -> None:
        name = func._schema.name.split("::")[-1]
        if func.namespace not in self.NAMESPACES or name in self.SKIP:
            return
        flat = []
        for a in list(args) + list(kwargs.values()):
            flat.extend(a if isinstance(a, (list, tuple)) else [a])
        n = sum(t.numel() * t.element_size() for t in flat if isinstance(t, torch.Tensor))
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0) + n

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                counter._seen(func, args, kwargs)
                return func(*args, **kwargs)

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        return False


# ---------------------------------------------------------------------------------
# ShardingRules: logical axis name -> mesh axis binding
# ---------------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ShardingRules:
    """Maps logical axis names to mesh axes; unknown names are replicated.
    A dim is sharded only if its size divides the product of its bound
    axes' sizes (else it is replicated: kv_heads 8 on a 16-way model axis,
    the Megatron fallback), and a mesh axis an earlier dim of the tensor
    already took is dropped, as in the reference."""

    rules: Dict[str, AxisBinding]
    strict_divisibility: bool = True

    def binding_for(self, logical_axes: Sequence[Optional[str]], shape: Sequence[int],
                    mesh) -> Tuple[AxisBinding, ...]:
        sizes = mesh_sizes(mesh)
        used: set = set()
        out: List[AxisBinding] = []
        for name, size in zip(logical_axes, shape):
            b = self.rules.get(name) if name is not None else None
            names = tuple(n for n in _axis_names(b) if n not in used and n in sizes)
            if not names:
                out.append(None)
                continue
            if self.strict_divisibility and size % math.prod(sizes[n] for n in names):
                out.append(None)  # divisibility fallback: replicate
                continue
            used.update(names)
            out.append(names[0] if len(names) == 1 else names)
        return tuple(out)

    def pspec(self, logical_axes, shape, mesh) -> Tuple[AxisBinding, ...]:
        """The binding, the port's stand-in for the reference's PartitionSpec."""
        return self.binding_for(logical_axes, shape, mesh)

    def placements(self, logical_axes, shape, mesh) -> List[Any]:
        """The binding as one DTensor Placement per dim of ``mesh`` (a
        ``DeviceMesh`` with dim names)."""
        return _placements_of(self.binding_for(logical_axes, shape, mesh), mesh)


# ---------------------------------------------------------------------------------
# trees of specs
# ---------------------------------------------------------------------------------
def is_spec(x) -> bool:
    """A parameter or moment spec (shape and logical axes, not a tensor)."""
    return hasattr(x, "logical_axes") and not isinstance(x, torch.Tensor)


def spec_axes(spec) -> Tuple[Optional[str], ...]:
    axes = spec.logical_axes
    return tuple(axes) if axes is not None else (None,) * len(spec.shape)


def q_shapes(spec) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The {"q", "scale"} buffers' shapes of a quantized spec (``spec.quant``)."""
    acc = spec.quant
    *lead, last = spec.shape
    if last % acc.block:
        raise ValueError(f"quantized last dim {last} must divide block {acc.block}")
    return (*lead, last if acc.bits == 8 else last // 2), (*lead, last // acc.block)


def q_bindings(spec, mesh, rules: ShardingRules) -> Dict[str, Tuple[AxisBinding, ...]]:
    """A quantized spec's buffers' bindings: "q" takes the spec's; "scale"
    inherits it but on its (blocked) last dim, which keeps its binding only
    where the block count divides it (the reference's ``_q_sharding``)."""
    binding = rules.binding_for(spec_axes(spec), spec.shape, mesh)
    *lead, last = binding
    nblocks = q_shapes(spec)[1][-1]
    sizes = mesh_sizes(mesh)
    if last is not None and nblocks % math.prod(sizes[n] for n in _axis_names(last)):
        last = None
    return {"q": binding, "scale": (*lead, last)}


def _quantized(spec) -> bool:
    return getattr(spec, "quant", None) is not None


def is_placements(x) -> bool:
    """A placement list (one Placement per mesh dim), a leaf of
    ``tree_shardings``."""
    from torch.distributed.tensor import Placement

    return isinstance(x, list) and bool(x) and all(isinstance(e, Placement) for e in x)


def tree_shardings(specs, mesh, rules: ShardingRules):
    """A tree of placement lists for a tree of specs ({"q", "scale"} of
    placement lists for quantized ones): the reference's ``tree_shardings``
    with Placements in the place of NamedShardings."""
    return tree_map(lambda s: ({k: _placements_of(b, mesh)
                                for k, b in q_bindings(s, mesh, rules).items()}
                               if _quantized(s) else rules.placements(spec_axes(s), s.shape, mesh)),
                    specs, is_leaf=is_spec)


def distribute(t: torch.Tensor, mesh, placements):
    """``t``, built alike on every rank, as a DTensor: each rank keeps its
    block, nothing is sent."""
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(t, mesh, placements, src_data_rank=None)


def tree_distribute(tree, specs, mesh, rules: ShardingRules):
    """A full tree of tensors that every rank built from the same seed (a
    quantized leaf is its {"q", "scale"} dict) laid onto ``mesh`` by the
    specs' placements."""
    return tree_map(lambda pl, t: distribute(t, mesh, pl), tree_shardings(specs, mesh, rules),
                    tree, is_leaf=is_placements)


def tree_full(tree):
    """A tree with every DTensor leaf gathered whole (``full_tensor``, a
    collective: every rank must call it, in the same order)."""
    return tree_map(lambda t: t.full_tensor() if is_dtensor(t) else t, tree)


def tree_param_bytes(specs) -> int:
    total = 0
    for s in tree_leaves(specs, is_leaf=is_spec):
        if _quantized(s):
            qs, ss = q_shapes(s)
            total += math.prod(qs) + math.prod(ss) * 4
        else:
            total += math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
    return total


def tree_param_count(specs) -> int:
    return sum(math.prod(s.shape) for s in tree_leaves(specs, is_leaf=is_spec))
