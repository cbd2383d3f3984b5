"""Dense layers of the port: parameter specs and their init, the Sharder,
rmsnorm and layernorm, RoPE, the gated MLP (SwiGLU, GeGLU) and the plain
gelu MLP with biases, embedding, the LM head and the loss.

Port of what the model families use of ``repro.models.layers``; weights keep the
reference's layouts (a dense linear is (d_in, d_out), applied as x @ w; a
quantized one is {"q", "scale"} stored output-major (d_out, d_in), applied
through ``kernels.ops.matmul``), so a bridged parameter tree is a
dtype/device copy. Every spec carries the reference's logical axes, which
``launch.sharding``'s rules bind to mesh axes (``core.distributed``); on a
mesh the parameters are DTensors, the MLP runs on local shards inside its
block's map (column- then row-parallel), and the embedding and the loss run
vocab-parallel in a ``local_map`` each (``apply_embed``,
``cross_entropy``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core.accessors import QuantizedAccessor
from repro_torch.core.distributed import (
    ShardingRules,
    is_dtensor,
    local_shape_and_offset,
    quantize_array,
    spec_axes,
)
from repro_torch.kernels import ops


# ---------------------------------------------------------------------------------
# parameter specs and init (the reference's TensorSpec init scheme)
# ---------------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One tensor of the model (a parameter or a cache): shape, dtype, init
    name ("zeros" | "ones" | "embed" | "normal" | "fan_in") and logical axes
    (one name or None a dim; None: every dim unnamed, so replicated on any
    mesh), as the reference's TensorSpec. With ``quant`` set the parameter is
    stored as that accessor's {"q", "scale"} buffers."""

    shape: Tuple[int, ...]
    dtype: torch.dtype
    init: str = "fan_in"
    quant: Optional[QuantizedAccessor] = None
    logical_axes: Optional[Tuple[Optional[str], ...]] = None

    def __post_init__(self):
        if self.logical_axes is not None and len(self.logical_axes) != len(self.shape):
            raise TypeError(f"axes/shape rank mismatch: {self}")

    @property
    def axes(self) -> Tuple[Optional[str], ...]:
        return spec_axes(self)


# ---------------------------------------------------------------------------------
# Sharder: the mesh and rules of a sharded step, and the activations' layouts
# ---------------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class Sharder:
    """The mesh and the rules a sharded step runs on. ``active(x)`` says
    whether the sharded path applies (each block then runs in one block map,
    ``core.distributed.block_map``, on local shards); calling it lays an
    activation out by its logical axis names (``x.redistribute`` to the
    placements ``rules`` give on ``mesh``, the twin of the reference's
    ``with_sharding_constraint``), which ``Model.forward`` does at the
    embedding's output and at the logits, and nothing inside a block; ``x``
    unchanged off-mesh or on a plain tensor."""

    mesh: Any = None
    rules: Optional[ShardingRules] = None
    # the block maps' layouts, by (block kind, config, input placements):
    # models.transformer._layout
    layouts: Dict[Any, Any] = dataclasses.field(default_factory=dict, compare=False,
                                                repr=False)

    def active(self, x) -> bool:
        """On a mesh, and ``x`` a DTensor: the sharded path applies."""
        return self.mesh is not None and self.rules is not None and is_dtensor(x)

    def __call__(self, x: torch.Tensor, *logical_axes: Optional[str]) -> torch.Tensor:
        if not self.active(x):
            return x
        return x.redistribute(self.mesh, self.rules.placements(logical_axes, x.shape, self.mesh))

    def place(self, x: Optional[torch.Tensor], *logical_axes: Optional[str]):
        """A plain tensor every rank holds whole (a serving batch's tokens,
        a context) as a DTensor laid out by ``logical_axes``: each rank keeps
        its block, nothing is sent. A DTensor or None passes unchanged."""
        if x is None or is_dtensor(x):
            return x
        from repro_torch.core.distributed import distribute

        return distribute(x, self.mesh, self.rules.placements(logical_axes, x.shape, self.mesh))


NULL_SHARDER = Sharder()


def init_param(spec: ParamSpec, generator: torch.Generator, device) -> torch.Tensor:
    """Draw one parameter: zeros / ones, normal(0.02) for "embed"/"normal", and
    normal(1/sqrt(shape[-2])) for "fan_in" (shape[-1] for a vector), drawn in
    f32 and cast — the reference's scheme; a quantized spec quantizes the f32
    draw (``quantize_array``). ``generator`` must live on ``device``."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=spec.dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=spec.dtype, device=device)
    if spec.init in ("embed", "normal"):
        std = 0.02
    elif spec.init == "fan_in":
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        std = 1.0 / math.sqrt(max(fan_in, 1))
    else:
        raise ValueError(f"unknown init {spec.init!r}")
    x = torch.empty(spec.shape, dtype=torch.float32, device=device)
    x.normal_(0.0, std, generator=generator)
    if spec.quant is not None:
        return quantize_array(x, spec.quant)
    return x.to(spec.dtype)


def init_tree(specs, generator: torch.Generator, device):
    """Initialize a nested dict/list of ParamSpecs, depth-first in key order."""
    if isinstance(specs, ParamSpec):
        return init_param(specs, generator, device)
    if isinstance(specs, dict):
        return {k: init_tree(v, generator, device) for k, v in specs.items()}
    return [init_tree(v, generator, device) for v in specs]


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec((d,), torch.float32, "ones", logical_axes=("embed",))


def layernorm_specs(d: int) -> Dict[str, ParamSpec]:
    return {"scale": ParamSpec((d,), torch.float32, "ones", logical_axes=("embed",)),
            "bias": ParamSpec((d,), torch.float32, "zeros", logical_axes=("embed",))}


def norm_specs(cfg):
    """The block norm's parameters: {"scale", "bias"} for layernorm, an
    rmsnorm scale otherwise (the reference's dispatch)."""
    return layernorm_specs(cfg.d_model) if cfg.norm == "layernorm" else rmsnorm_spec(cfg.d_model)


def fit_quant(quant: Optional[QuantizedAccessor], d_in: int) -> Optional[QuantizedAccessor]:
    """The largest block <= quant.block out of (quant.block, 128, 64, 32),
    at least 16, that divides d_in; None (dense storage) when none does."""
    if quant is None:
        return None
    for b in (quant.block, 128, 64, 32):
        if b <= quant.block and d_in % b == 0 and b >= 16:
            return dataclasses.replace(quant, block=b)
    return None


def linear_spec(d_in: int, d_out: int, axes: Tuple[Optional[str], Optional[str]] = (None, None),
                *, dtype, quant: Optional[QuantizedAccessor] = None,
                init: str = "fan_in") -> ParamSpec:
    """Weight spec with logical ``axes`` (d_in's, d_out's). Dense storage:
    (d_in, d_out). Quantized storage: output-major (d_out, d_in) intN +
    per-(row, block) scales, the layout quant_matmul reads, its axes swapped
    alike."""
    quant = fit_quant(quant, d_in)
    if quant is not None:
        return ParamSpec((d_out, d_in), dtype, init, quant, (axes[1], axes[0]))
    return ParamSpec((d_in, d_out), dtype, init, logical_axes=tuple(axes))


GATED_ACTS = ("swiglu", "geglu")


def mlp_specs(cfg, quant: Optional[QuantizedAccessor] = None) -> Dict[str, ParamSpec]:
    """The MLP's weights: the gated MLP's (SwiGLU and GeGLU share the leaf
    names), or for any other ``mlp_act`` (whisper's "gelu") the plain MLP's
    w_up / w_down with f32 biases b_up / b_down, as in the reference."""
    d, f, dt = cfg.d_model, cfg.d_ff, cfg.param_dtype
    if cfg.mlp_act in GATED_ACTS:
        return {
            "w_gate": linear_spec(d, f, ("embed", "ffn"), dtype=dt, quant=quant),
            "w_up": linear_spec(d, f, ("embed", "ffn"), dtype=dt, quant=quant),
            "w_down": linear_spec(f, d, ("ffn", "embed"), dtype=dt, quant=quant),
        }
    return {
        "w_up": linear_spec(d, f, ("embed", "ffn"), dtype=dt, quant=quant),
        "b_up": ParamSpec((f,), torch.float32, "zeros", logical_axes=("ffn",)),
        "w_down": linear_spec(f, d, ("ffn", "embed"), dtype=dt, quant=quant),
        "b_down": ParamSpec((d,), torch.float32, "zeros", logical_axes=("embed",)),
    }


def embed_specs(cfg) -> Dict[str, ParamSpec]:
    s = {"embedding": ParamSpec((cfg.vocab_padded, cfg.d_model), cfg.param_dtype, "embed",
                                logical_axes=("vocab", "embed"))}
    if not cfg.tie_embeddings:  # the head sharded on the vocab: a vocab-parallel loss
        s["lm_head"] = ParamSpec((cfg.d_model, cfg.vocab_padded), cfg.param_dtype,
                                 logical_axes=("embed", "vocab"))
    return s


# ---------------------------------------------------------------------------------
# apply functions
# ---------------------------------------------------------------------------------
def apply_linear(x: torch.Tensor, w) -> torch.Tensor:
    """x (..., d_in) @ w: a dense (d_in, d_out) tensor, or quantized
    {"q", "scale"} buffers read as int8, the reference's default accessor."""
    if isinstance(w, dict):
        return ops.matmul(x, w, QuantizedAccessor(x.dtype, bits=8))
    return torch.matmul(x, w.to(x.dtype))


def apply_rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


def apply_layernorm(x: torch.Tensor, p: Dict[str, torch.Tensor], eps: float = 1e-5) -> torch.Tensor:
    """(x - mean) / sqrt(var + eps) * scale + bias, mean and variance in f32,
    cast back to x's dtype."""
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean((xf - mu) ** 2, dim=-1, keepdim=True)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]).to(x.dtype)


def apply_norm(cfg, x: torch.Tensor, p) -> torch.Tensor:
    return apply_layernorm(x, p) if cfg.norm == "layernorm" else apply_rmsnorm(x, p)


def rope_freqs(d_head: int, theta: float, device=None) -> torch.Tensor:
    half = d_head // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32, device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, H, T, D); positions: (T,) or (B, T) absolute positions. Rotates
    the half-split pairs (x[..., i], x[..., i + D/2]), as the reference does."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)
    ang = positions.float()[..., None] * freqs  # (T, D/2) or (B, T, D/2)
    ang = ang[None, None] if positions.dim() == 1 else ang[:, None]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def apply_mlp(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor, lm=None) -> torch.Tensor:
    """Gated (swiglu, geglu): act(x @ w_gate) * (x @ w_up) @ w_down, the
    activation in f32 (silu, or tanh-approximated gelu). Otherwise the plain
    MLP: gelu_tanh(x @ w_up + b_up) @ w_down + b_down, the gelu in f32 and
    each bias cast to x's dtype. Inside a block map (``lm``, a
    ``core.distributed.LocalMesh``) with the "ffn" columns split over
    "model": the up / gate matmuls on the local columns (column-parallel),
    the down matmul on the local rows (row-parallel) and one sum over
    "model", the down bias after it."""
    w_up = p["w_up"]
    split = (lm is not None and lm.model is not None and not isinstance(w_up, dict)
             and w_up.shape[-1] < cfg.d_ff)
    if split:
        x = lm.enter(x)
    if cfg.mlp_act not in GATED_ACTS:
        h = apply_linear(x, w_up) + p["b_up"].to(x.dtype)
        y = apply_linear(gelu_tanh(h.float()).to(x.dtype), p["w_down"])
        return (lm.sum(y) if split else y) + p["b_down"].to(x.dtype)
    act = F.silu if cfg.mlp_act == "swiglu" else gelu_tanh
    g = apply_linear(x, p["w_gate"])
    u = apply_linear(x, w_up)
    y = apply_linear(act(g.float()).to(x.dtype) * u, p["w_down"])
    return lm.sum(y) if split else y


def _embed_sharded(table, tokens):
    """The embedding rows of DTensor ``tokens`` from a DTensor ``table``
    whose vocab dim may be sharded, inside ``local_map``: each rank looks up
    the tokens in its own rows (zeros for the others) and the rows are
    summed over the vocab's mesh dims, so the table is never assembled.
    The table comes in whole on its embed dim; its gradient leaves as a
    Partial sum over the mesh dims that shard the tokens."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.distributed import group_sum

    mesh = table.device_mesh
    vocab = [isinstance(p, Shard) and p.dim == 0 for p in table.placements]
    t_pl = [Replicate() if v else p for v, p in zip(vocab, tokens.placements)]
    tab_pl = [Shard(0) if v else Replicate() for v in vocab]
    tab_grad = [Shard(0) if v else Partial() if isinstance(p, Shard) else Replicate()
                for v, p in zip(vocab, t_pl)]
    groups = [mesh.get_group(i) for i, v in enumerate(vocab) if v]
    first = local_shape_and_offset(table.shape, tab_pl, mesh)[1][0]

    def local(tab, tok):
        idx = tok.long() - first
        live = (idx >= 0) & (idx < tab.shape[0])
        rows = tab[idx.clamp(0, tab.shape[0] - 1)]
        return group_sum(torch.where(live[..., None], rows, torch.zeros_like(rows)), groups)

    return local_map(local, out_placements=t_pl, in_placements=(tab_pl, t_pl),
                     in_grad_placements=(tab_grad, t_pl), device_mesh=mesh,
                     redistribute_inputs=True)(table, tokens)


def apply_embed(p: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
    """The embedding rows of ``tokens``: an index off-mesh, a vocab-parallel
    lookup on DTensors (``_embed_sharded``)."""
    if is_dtensor(tokens):
        return _embed_sharded(p["embedding"], tokens)
    return p["embedding"][tokens.long()]


def apply_lm_head(cfg, p: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    w = p["embedding"].t() if cfg.tie_embeddings else p["lm_head"]
    logits = torch.matmul(x, w.to(x.dtype))
    vp = logits.shape[-1]
    if vp != cfg.vocab:  # mask padded vocab slots
        mask = torch.arange(vp, device=logits.device) < cfg.vocab
        logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
    return logits


def _vocab_parallel_nll(logits, labels):
    """-log softmax(logits)[label] of DTensors, each rank on its own block
    of the vocab (inside ``local_map``): the row max all-reduced (MAX), the
    sum of exp(logits - max) all-reduced, and the label's logit picked in
    the local block (zero where the label lies outside the local vocab range)
    and all-reduced: the reference's masked reduction, where a gather on the
    DTensor would assemble whole rows (4 x 2048 x 128256
    f32 is 4.2 GB a rank at llama3.2-1b's cell). -> nll laid out as the
    logits' leading dims."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    from repro_torch.core.distributed import group_max, group_sum

    mesh, vdim = logits.device_mesh, logits.dim() - 1
    lp = list(logits.placements)
    rows = [p if isinstance(p, Shard) and p.dim < vdim else Replicate() for p in lp]
    labels = labels.redistribute(mesh, rows)
    groups = [mesh.get_group(i) for i, p in enumerate(lp)
              if isinstance(p, Shard) and p.dim == vdim]
    first = local_shape_and_offset(logits.shape, lp, mesh)[1][vdim]

    def local(lg, lb):
        lg = lg.float()
        m = group_max(lg.amax(dim=-1), groups)
        lse = torch.log(group_sum(torch.exp(lg - m[..., None]).sum(dim=-1), groups)) + m
        idx = lb.long() - first  # the label's column in this rank's block of the vocab
        live = (idx >= 0) & (idx < lg.shape[-1])
        got = torch.gather(lg, -1, idx.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        ll = group_sum(torch.where(live, got, torch.zeros_like(got)), groups)
        return lse - ll

    return local_map(local, out_placements=rows, in_placements=(lp, rows),
                     device_mesh=mesh)(logits, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean CE over valid positions, the reference's: logits (..., V) in f32
    (the padded vocab columns already -1e9 from ``apply_lm_head``), a
    log-sum-exp shifted by the row max, the label's logit picked out, and
    with ``mask`` the sum of nll * mask over max(sum(mask), 1). Off-mesh the
    label's logit is picked by ``torch.gather``; on DTensors the whole of it
    runs vocab-parallel (``_vocab_parallel_nll``), the reference's masked
    reduction over the vocab axis."""
    if is_dtensor(logits):
        nll = _vocab_parallel_nll(logits, labels)
    else:
        logits = logits.float()
        m = logits.amax(dim=-1, keepdim=True)
        lse = torch.log(torch.exp(logits - m).sum(dim=-1)) + m[..., 0]
        ll = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
        nll = lse - ll
    if mask is not None:
        mask = mask.to(nll.dtype)
        return (nll * mask).sum() / torch.clamp(mask.sum(), min=1)
    return nll.mean()
