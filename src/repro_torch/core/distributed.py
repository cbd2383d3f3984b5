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

Also here: the block map (``block_map``: a block's body in one
``local_map`` on local shards, its placements from the parameters' and its
collectives explicit, ``LocalMesh``), the collectives ``local_map`` bodies
call with the gradients they need (``group_sum``, ``group_mean``,
``group_max``; the Megatron entry, the reduce-scatter and the all-gather
behind ``LocalMesh``), a counter of the collectives a step runs
(``CollectiveCounter``) and of the DTensor ops and redistributions it
dispatches (``DispatchCounter``), and, re-exported from
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


def local_tensor(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's local shard outside autograd (the optimizer's update): its
    local tensor as stored, without ``to_local``'s autograd node."""
    loc = getattr(t, "_local_tensor", None)
    return loc if loc is not None else t.to_local()


def placed_like(local: torch.Tensor, ref) -> torch.Tensor:
    """``local``, this rank's shard, as a DTensor laid out as DTensor ``ref``
    (the same mesh, placements and global shape) and outside autograd:
    ``ref``'s own spec reused where the DTensor class takes one (a few us
    against ``from_local``'s ~40)."""
    from torch.distributed.tensor import DTensor

    spec = getattr(ref, "_spec", None)
    if spec is not None and local.dtype == ref.dtype and local.shape == local_tensor(ref).shape:
        try:
            return DTensor(local, spec, requires_grad=False)
        except TypeError:
            pass
    return DTensor.from_local(local, ref.device_mesh, ref.placements, run_check=False,
                              shape=ref.shape, stride=ref.stride())


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


def grad_scaled(x: torch.Tensor, grad_scale: float) -> torch.Tensor:
    """``x`` whose gradient is scaled by ``grad_scale`` (a term every rank
    computes alike, whose gradients are then summed over the ranks)."""
    return _Scale.apply(x, 1.0, grad_scale)


def group_max(x: torch.Tensor, groups) -> torch.Tensor:
    """The elementwise max of ``x`` over each group (no gradient)."""
    import torch.distributed as dist

    x = x.detach().clone()
    for g in _wide(groups):
        dist.all_reduce(x, op=dist.ReduceOp.MAX, group=g)
    return x


class _EnterGroup(torch.autograd.Function):
    """Megatron's entry to a block split over a group: the identity forward;
    the backward sums the gradient over the group, where each rank's is the
    part its share of the block (its heads, columns or experts) took."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _SumBothWays(torch.autograd.Function):
    """The sum over a group of per-rank partials that each rank then uses for
    its own share (the gated norm's sum of squares over a split width): the
    gradient of the sum is the sum of the ranks' gradients, an all-reduce in
    the backward too."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def _scatter_sum(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] // n, *src.shape[1:]), dtype=x.dtype, device=x.device)
    dist.reduce_scatter_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()  # the kernels downstream take contiguous operands


def _gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    import torch.distributed as dist

    n = dist.get_world_size(group)
    src = x.movedim(dim, 0).contiguous()
    out = torch.empty((src.shape[0] * n, *src.shape[1:]), dtype=x.dtype, device=x.device)
    dist.all_gather_into_tensor(out, src, group=group)
    return out.movedim(0, dim).contiguous()


class _ReduceScatter(torch.autograd.Function):
    """Each rank's partial sum of a whole tensor -> the rank's block of the
    sum along ``dim`` (a reduce-scatter); the backward all-gathers the
    blocks' gradients, which every rank's partial term then takes whole."""

    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _scatter_sum(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.dim, ctx.group), None, None


class _AllGather(torch.autograd.Function):
    """The ranks' blocks along ``dim`` gathered whole on every rank. With
    ``summed`` the backward reduce-scatters (each rank's gradient of the
    whole is a part: their sum, back to the block's owner); without it each
    rank computed the same gradient and keeps its own block of it."""

    @staticmethod
    def forward(ctx, x, dim, group, summed=True):
        import torch.distributed as dist

        ctx.dim, ctx.group, ctx.summed = dim, group, summed
        ctx.rank, ctx.size = dist.get_rank(group), x.shape[dim]
        return _gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        if ctx.summed:
            return _scatter_sum(g, ctx.dim, ctx.group), None, None, None
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None


# ---------------------------------------------------------------------------------
# the block map: one local_map a block, its collectives explicit
# ---------------------------------------------------------------------------------
def _lse_weighted(out: torch.Tensor, lse: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(w out | w) in f32, w = exp(lse - m) and 0 where lse is -inf (a part
    with no live key): one part's share of ``merge_lse``'s sums."""
    lse = lse.float()
    live = lse > -math.inf
    w = torch.where(live, torch.exp(lse - torch.where(live, m, lse)), torch.zeros_like(lse))
    return torch.cat([out.float() * w[..., None], w[..., None]], dim=-1)


def _lse_normalized(buf: torch.Tensor, dtype) -> torch.Tensor:
    den = buf[..., -1:]
    res = torch.where(den > 0, buf[..., :-1] / torch.where(den > 0, den, torch.ones_like(den)),
                      torch.zeros_like(buf[..., :-1]))
    return res.to(dtype)


def merge_lse_parts(outs: Sequence[torch.Tensor], lses: Sequence[torch.Tensor]) -> torch.Tensor:
    """``LocalMesh.merge_lse`` over parts held in one process (each part
    the attention over one slice of the keys, in rank order): the ranks'
    merge emulated, for checks on one device."""
    m = torch.stack([lse.float() for lse in lses]).amax(dim=0)
    buf = sum(_lse_weighted(o, lse, m) for o, lse in zip(outs, lses))
    return _lse_normalized(buf, outs[0].dtype)


@dataclasses.dataclass(frozen=True)
class LocalMesh:
    """What a block body running on local shards knows of its mesh: the
    "model" axis' group (None where the mesh has no model axis or one rank
    on it), its size and this rank's place on it, and the groups of the mesh
    dims that shard the block's tokens (its batch). The methods are the
    block's explicit collectives, each with the gradient the Megatron
    split needs; on a model axis of one rank each is the identity."""

    model: Any = None
    model_size: int = 1
    model_rank: int = 0
    tokens: Tuple[Any, ...] = ()

    def enter(self, x: torch.Tensor) -> torch.Tensor:
        """The entry of a split branch: identity forward, the gradient
        summed over "model" (x, replicated there, gets its whole gradient)."""
        return x if self.model is None else _EnterGroup.apply(x, self.model)

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """A row-parallel exit: the sum over "model", identity backward."""
        return x if self.model is None else _GroupSum.apply(x, self.model)

    def sum_both(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over "model" of partials each rank goes on to use for its
        own share: an all-reduce both ways."""
        return x if self.model is None else _SumBothWays.apply(x, self.model)

    def scatter(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Each rank's partial of a whole tensor -> this rank's block of the
        sum along ``dim`` (reduce-scatter; all-gather backward)."""
        return x if self.model is None else _ReduceScatter.apply(x, dim, self.model)

    def gather_tokens(self, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
        """The token shards of ``x`` gathered whole along ``dim`` over the
        token groups (all-gather; reduce-scatter backward)."""
        for g in _wide(self.tokens)[::-1]:
            x = _AllGather.apply(x, dim, g)
        return x

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The "model" ranks' blocks of ``x`` along ``dim`` gathered whole on
        every rank (all-gather; serving's, no backward): a head-split q
        before a sharded decode, vocab-split logits."""
        return x if self.model is None else _gather(x, dim, self.model)

    def merge_lse(self, out: torch.Tensor, lse: torch.Tensor) -> torch.Tensor:
        """The exact log-sum-exp merge over "model" of attention partials,
        each rank's over its own slice of the keys: ``out`` (..., D) the
        rank's normalized output, ``lse`` (...) its natural log-sum-exp of
        the scaled scores (-inf: no live key, weight 0). With M the ranks'
        max lse and w = exp(lse - M), the result is sum(w out) / sum(w) (0
        where every weight is 0): the reference's pmax(m), psum(l w),
        psum(acc w), as one MAX all-reduce of lse and one SUM all-reduce of
        (w out | w) in f32. Out in ``out``'s dtype. No backward."""
        if self.model is None:
            return out
        import torch.distributed as dist

        m = lse.float().clone()
        dist.all_reduce(m, op=dist.ReduceOp.MAX, group=self.model)
        buf = _lse_weighted(out, lse, m)
        dist.all_reduce(buf, group=self.model)
        return _lse_normalized(buf, out.dtype)

    def token_rank_and_count(self) -> Tuple[int, int]:
        """This rank's place among the token shards and their count, in the
        order ``gather_tokens`` concatenates them (the first group major)."""
        import torch.distributed as dist

        rank, count = 0, 1
        for g in self.tokens:
            n = dist.get_world_size(g)
            rank, count = rank * n + dist.get_rank(g), count * n
        return rank, count


def local_mesh(mesh, x_placements) -> LocalMesh:
    """The LocalMesh of ``mesh`` for a block whose input lies in
    ``x_placements``."""
    from torch.distributed.tensor import Shard

    names = list(mesh.mesh_dim_names)
    tokens = tuple(mesh.get_group(i) for i, p in enumerate(x_placements)
                   if isinstance(p, Shard) and names[i] != "model")
    if "model" not in names or mesh.size(names.index("model")) == 1:
        return LocalMesh(tokens=tokens)
    i = names.index("model")
    return LocalMesh(mesh.get_group(i), mesh.size(i), mesh.get_local_rank("model"), tokens)


def is_split(t, dim: int) -> bool:
    """Is DTensor ``t``'s dim ``dim`` sharded over the mesh's "model" axis (of
    more than one rank)?"""
    from torch.distributed.tensor import Shard

    if not is_dtensor(t):
        return False
    names = list(t.device_mesh.mesh_dim_names)
    if "model" not in names:
        return False
    i = names.index("model")
    return t.device_mesh.size(i) > 1 and t.placements[i] == Shard(dim % t.dim())


def _leaf_plan(t, key, names, rows, whole, partial):
    """How a block body takes one parameter leaf that comes in as it lies on
    the mesh: ([(tensor dim, group, sum the gradients)] all-gathers, minor
    mesh dim first, each with a reduce-scatter backward where the ranks'
    gradients are parts of the whole, else a slice of the rank's block),
    [groups] whose ranks' gradients of the leaf are each a part, summed by
    an all-reduce in the backward). Mesh dims of one rank are skipped: a
    shard of one is the whole."""
    from torch.distributed.tensor import Shard

    mesh = t.device_mesh
    gathers, sums = [], []
    for i in reversed(range(len(names))):
        if mesh.size(i) == 1:
            continue
        p, group = t.placements[i], mesh.get_group(i)
        model = names[i] == "model"
        if isinstance(p, Shard):
            if not model:  # FSDP: gathered at the block's entry
                gathers.append((p.dim, group, i in rows))
            elif key in whole:
                gathers.append((p.dim, group, key in partial))
        elif (key in partial) if model else (i in rows):
            sums.append(group)
    return gathers, sums


def _take_leaf(t: torch.Tensor, plan) -> torch.Tensor:
    gathers, sums = plan
    for dim, group, summed in gathers:
        t = _AllGather.apply(t, dim, group, summed)
    for group in sums:
        t = _EnterGroup.apply(t, group)
    return t


@dataclasses.dataclass(frozen=True)
class BlockLayout:
    """What a block map derives from its leaves' placements: each leaf's
    input placements and entry plan (``_leaf_plan``), and the block's
    LocalMesh. Every layer of a block kind on one mesh has the same, so a
    caller may keep it (``block_map(layout=)``)."""

    in_placements: Tuple[Any, ...]
    plans: Tuple[Any, ...]
    lm: LocalMesh


def block_layout(mesh, x, params, *, whole=(), partial=()) -> BlockLayout:
    from torch.distributed.tensor import Shard

    from .tree import tree_leaves_with_path

    names = list(mesh.mesh_dim_names)
    rows = {i for i, p in enumerate(x.placements) if isinstance(p, Shard)}
    whole, partial = set(whole), set(partial)
    pairs = tree_leaves_with_path(params)
    return BlockLayout(tuple(t.placements for _, t in pairs),
                       tuple(_leaf_plan(t, "/".join(map(str, path)), names, rows, whole, partial)
                             for path, t in pairs),
                       local_mesh(mesh, x.placements))


def block_map(body, mesh, x, params, extras=(), *, whole=(), partial=(), aux: bool = False,
              layout: Optional[BlockLayout] = None):
    """Run ``body(lm, x, params, *extras)`` once, inside one ``local_map``, on
    this rank's shards: ``lm`` the block's ``LocalMesh``, ``x`` (B, T, D)
    (sharded over the batch axes, replicated over "model"), ``params`` the
    block's parameter tree of local tensors, ``extras`` more activations laid
    out as x (a cross-attention context; None passes through). The body's
    collectives are its own (``LocalMesh``'s methods); -> y laid out as x
    (and, with ``aux``, a scalar replicated everywhere).

    Every input comes into the map as it lies (the parameters as the rules
    laid them out, ``tree_distribute``): DTensor redistributes nothing, and
    each gradient leaves in its input's placements. At the entry each leaf
    is made what the body reads, explicitly (``_leaf_plan``): gathered over
    every mesh dim but "model" (FSDP's all-gather, its backward the
    reduce-scatter of the ranks' parts; redone in the backward under
    remat), and over "model" too for the leaves of ``whole`` (paths "a/b"
    in the tree). A leaf's gradient is summed over "model" for the leaves
    of ``partial`` (those a split body uses only in its share) and over the
    batch axes where the batch is sharded and the leaf is not; elsewhere
    every rank computed the same. x and the extras get their whole gradient
    (the body enters its split branches through ``lm.enter``). ``layout``:
    ``block_layout``'s of these arguments, when the caller keeps it."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    from .tree import tree_leaves

    if layout is None:
        layout = block_layout(mesh, x, params, whole=whole, partial=partial)
    leaves = tree_leaves(params)
    n, plans, lm = len(leaves), layout.plans, layout.lm

    def local(x_, *rest):
        it = iter(_take_leaf(t, plan) for t, plan in zip(rest[:n], plans))
        p_ = tree_map(lambda _: next(it), params)
        return body(lm, x_, p_, *rest[n:])

    x_pl = list(x.placements)  # a list: local_map reads a tuple as one entry an output
    out_pl = (x_pl, [Replicate()] * len(x_pl)) if aux else x_pl
    ex_pl = [None if e is None else e.placements for e in extras]
    return local_map(local, out_placements=out_pl,
                     in_placements=(x_pl, *layout.in_placements, *ex_pl),
                     in_grad_placements=(x_pl, *layout.in_placements, *ex_pl),
                     device_mesh=mesh)(x, *leaves, *extras)


class CollectiveCounter:
    """Counts the collectives run while it is entered, by op name: calls and
    the bytes of their input tensors (what each rank hands the collective).
    It sees both the process-group ops (``c10d``: ``dist.all_reduce`` in the
    port's ``local_map`` bodies) and the functional ones DTensor's
    redistributions run (``_c10d_functional``), in the forward and the
    backward, through a ``TorchDispatchMode``; every op pays a Python call
    while it is entered, so count one step, not a timed one. A call's bytes
    are those of all its tensor arguments, an all-gather's or a
    reduce-scatter's output buffer among them. The redistributions DTensor
    runs inside an op's dispatch (a ``local_map``'s inputs, a gradient's
    placement) happen while the mode is off the stack and are not counted;
    ``launch.dryrun.StepTracer`` counts those too.

    With ``record`` each call is also kept in ``records``: its op name, the
    shape and dtype of what the rank hands it (``input_bytes``, without the
    output buffer), its group's size, and its origin, the innermost frame of
    the port outside this module and the files of ``origin_skip`` as
    "file:line function"."""

    NAMESPACES = ("c10d", "_c10d_functional")
    # not collectives: a wait, the barriers, and the autograd wrapper a
    # functional collective's output gets outside FakeTensorMode
    SKIP = ("wait_tensor", "barrier", "monitored_barrier", "_wrap_tensor_autograd")
    INPUTS = ("tensors", "input", "input_tensor", "input_tensors")

    def __init__(self, record: bool = False, origin_skip: Sequence[str] = ()):
        self.calls: Dict[str, int] = {}
        self.bytes: Dict[str, int] = {}
        self.record = record
        self.origin_skip = ("core/distributed.py",) + tuple(origin_skip)
        self.records: List[Dict[str, Any]] = []
        self._mode = None

    def seen(self, func, args, kwargs) -> None:
        """Count one dispatched op (nothing unless it is a collective)."""
        name = func._schema.name.split("::")[-1]
        if func.namespace not in self.NAMESPACES or name in self.SKIP:
            return
        flat = []
        for a in list(args) + list(kwargs.values()):
            flat.extend(a if isinstance(a, (list, tuple)) else [a])
        n = sum(t.numel() * t.element_size() for t in flat if isinstance(t, torch.Tensor))
        self.calls[name] = self.calls.get(name, 0) + 1
        self.bytes[name] = self.bytes.get(name, 0) + n
        if self.record:
            self.records.append(_collective_record(name, func, args, kwargs, self.origin_skip))

    def __enter__(self):
        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                counter.seen(func, args, kwargs)
                return func(*args, **kwargs)

        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        return False


def _group_size(named: Dict[str, Any]) -> int:
    """The size of a collective's group: its ProcessGroup's (c10d ops), or
    the group the functional ops name."""
    from torch.distributed import ProcessGroup
    from torch.distributed.distributed_c10d import _resolve_process_group

    pg = named.get("process_group")
    if pg is not None:
        return int(ProcessGroup.unbox(pg).size())
    return int(_resolve_process_group(named["group_name"]).size())


def _origin(skip: Sequence[str]) -> str:
    """The innermost frame of the port whose file (relative to the package)
    is not in ``skip``, as "file:line function"."""
    import os
    import traceback

    port = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for fr in reversed(traceback.extract_stack()):
        path = os.path.abspath(fr.filename)
        if path.startswith(port + os.sep):
            rel = os.path.relpath(path, port).replace(os.sep, "/")
            if rel not in skip:
                return f"{rel}:{fr.lineno} {fr.name}"
    return "?"


def _collective_record(name, func, args, kwargs, origin_skip) -> Dict[str, Any]:
    names = [a.name for a in func._schema.arguments]
    named = {**dict(zip(names, args)), **kwargs}
    ins = []
    for k in CollectiveCounter.INPUTS:
        v = named.get(k)
        ins.extend(v if isinstance(v, (list, tuple)) else [v] if v is not None else [])
    ins = [t for t in ins if isinstance(t, torch.Tensor)]
    return {"op": name, "shape": [list(t.shape) for t in ins],
            "dtype": str(ins[0].dtype) if ins else None, "group_size": _group_size(named),
            "input_bytes": sum(t.numel() * t.element_size() for t in ins),
            "origin": _origin(origin_skip)}


class DispatchCounter:
    """Counts, while it is entered, the ops dispatched on DTensors (an op
    with a DTensor among its arguments: each pays DTensor's sharding
    propagation on the host) and the redistributions DTensor runs (its
    ``redistribute_local_tensor``: the ``redistribute`` calls, a
    ``local_map``'s input placements, an op's implicit resharding), in the
    forward and the backward; the ops on plain local tensors inside a
    ``local_map`` are not counted. By op name in ``ops``."""

    _MODULES = ("_api", "_dispatch", "_redistribute")

    def __init__(self):
        self.ops: Dict[str, int] = {}
        self.redistributions = 0
        self._mode = None
        self._saved = []

    @property
    def dtensor_ops(self) -> int:
        return sum(self.ops.values())

    def __enter__(self):
        import importlib

        from torch.utils._python_dispatch import TorchDispatchMode

        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                kwargs = kwargs or {}
                flat = []
                for a in list(args) + list(kwargs.values()):
                    flat.extend(a if isinstance(a, (list, tuple)) else [a])
                if any(is_dtensor(a) for a in flat):
                    name = func._schema.name.split("::")[-1]
                    counter.ops[name] = counter.ops.get(name, 0) + 1
                return func(*args, **kwargs)

        for name in self._MODULES:
            mod = importlib.import_module(f"torch.distributed.tensor.{name}")
            orig = mod.redistribute_local_tensor

            def counted(*a, _orig=orig, **kw):
                counter.redistributions += 1
                return _orig(*a, **kw)

            self._saved.append((mod, orig))
            mod.redistribute_local_tensor = counted
        self._mode = _Mode()
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        self._mode.__exit__(*exc)
        self._mode = None
        for mod, orig in self._saved:
            mod.redistribute_local_tensor = orig
        self._saved = []
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
