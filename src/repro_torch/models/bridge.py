"""Weight bridge: the reference's parameter pytree (as numpy) -> the port's.

The input is ``jax.tree.map(np.asarray, params)`` of a ``repro`` Model: every
per-layer leaf of a block-program entry is stacked with a leading layer dim.
The port keeps the same leaf names and layouts (wq stays (d, h, k), wo (h,
k, d), in_proj (d, d_in_proj), ...) and one dict per layer, so the bridge
only splits the layer dim and copies
dtype-for-dtype to the device. Quantized weights ({"q", "scale"} leaves of a
``build_model(cfg, quantized=True)`` model) come through the same way: int8
stays int8, f32 scales stay f32, and both split on the layer dim. The MoE
family's leaves are no different: the layernorm {"scale", "bias"} dicts
(final_norm included), the f32 router (D, E) and the 3-D experts (E, D, F) /
(E, F, D), dense or {"q", "scale"} blocked along the last dim. The
encoder-decoder and vision families add the "encoder" subtree and the vision
groups' doubly stacked self layers.

The other way: ``to_reference_layout`` stacks a port tree of the model's
shape (parameters, gradients, or an AdamW moment tree, whose leaves may be
{"q", "scale"} dicts) into the reference's nesting as torch tensors,
``to_jax_layout`` gives the same as numpy, and ``reference_shapes`` gives a
ParamSpec tree's leaf shapes as the reference stacks them (what the
optimizer's decay and int8 rules read). The checkpoint store writes the
stacked form, so a checkpoint of either package restores in the other. This
module imports neither JAX nor repro.
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core.distributed import is_dtensor
from repro_torch.core.tree import tree_map
from repro_torch.kernels.common import resolve_device

from .transformer import KINDS, VisGroup, block_program


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a.to(device)
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _split(tree, n: int, device):
    """A stacked subtree -> ``n`` per-layer dicts on ``device``."""
    stacked = tree_map(lambda a: _tensor(a, device), tree)
    return [tree_map(lambda t, l=l: t[l], stacked) for l in range(n)]


def from_jax_params(np_tree, cfg, device=None):
    """Port parameters from a numpy copy of the reference's parameter pytree
    (or that tree as torch tensors, ``to_reference_layout``'s output) for
    ``cfg``, or any tree of its shape (gradients, AdamW moments): every
    entry of ``block_program(cfg)`` (dense, moe, ssm, rec, rg_group with its
    nested {"rec0", "rec1", "attn"} stacks, dec, vis_group)
    split on its own leading layer dim; a vision group's doubly stacked
    "self" leaves (G, 4, ...) into a list of 4 layer dicts a group, its (G,)
    f32 gate into a 0-d tensor a group; whisper's "encoder" subtree split
    likewise. -> {"embed", "blocks": [[layer dict] * count per program
    entry], "final_norm"[, "encoder"]} on ``device`` (CUDA unless the caller
    names one)."""
    device = resolve_device(device)
    program = block_program(cfg)
    if len(np_tree["blocks"]) != len(program):
        raise ValueError(f"{len(np_tree['blocks'])} block stacks for a program of "
                         f"{len(program)} entries ({program})")
    blocks = []
    for (kind, n), tree in zip(program, np_tree["blocks"]):
        layers = _split(tree, n, device)
        if kind == "vis_group":
            for p in layers:
                p["self"] = [tree_map(lambda t, i=i: t[i], p["self"])
                             for i in range(VisGroup.N_SELF)]
        blocks.append(layers)
    out = {
        "embed": tree_map(lambda a: _tensor(a, device), np_tree["embed"]),
        "blocks": blocks,
        "final_norm": tree_map(lambda a: _tensor(a, device), np_tree["final_norm"]),
    }
    if "encoder" in np_tree:
        enc = np_tree["encoder"]
        out["encoder"] = {
            "blocks": [_split(enc["blocks"][0], cfg.n_enc_layers, device)],
            "final_norm": tree_map(lambda a: _tensor(a, device), enc["final_norm"]),
        }
    return out


def _stack(layers):
    """Same-structure trees of tensors -> one tree of tensors stacked on a
    new leading dim."""
    if isinstance(layers[0], dict):
        return {k: _stack([l[k] for l in layers]) for k in layers[0]}
    return torch.stack(layers)


def _zero_stack(spec) -> torch.Tensor:
    return torch.zeros((0,) + tuple(spec.shape), dtype=spec.dtype)


def to_reference_layout(tree, cfg, *, device=None,
                        empty: Optional[Callable[[Any], Any]] = None):
    """A port tree of the model's shape -> the reference's nesting as torch
    tensors (detached, moved to ``device`` when given): every program entry's
    layers stacked on a leading dim, a vision group's list of self layers
    stacked first (leaves (G, 4, ...)) and its 0-d gate into (G,), whisper's
    encoder likewise; a DTensor leaf is gathered whole first (leaf by leaf, on
    every rank). A program entry of no layers (the hybrid family's
    zero-count group) becomes ``empty(spec)`` of each of its ParamSpecs (by
    default a (0, ...) zero tensor of the spec's dtype), as the reference
    keeps an empty stack there."""
    empty = empty or _zero_stack

    def leaf(t):
        if is_dtensor(t):  # a collective: every rank converts the same tree
            t = t.full_tensor()
        t = t.detach()
        return t.to(device) if device is not None else t

    def layer(p):
        p = tree_map(leaf, p)
        if isinstance(p, dict) and isinstance(p.get("self"), list):
            p = dict(p, self=_stack(p["self"]))
        return p

    def entry(kind, layers):
        if layers:
            return _stack([layer(p) for p in layers])
        return tree_map(empty, KINDS[kind].specs(cfg))

    out = {
        "embed": tree_map(leaf, tree["embed"]),
        "blocks": [entry(kind, layers)
                   for (kind, _), layers in zip(block_program(cfg), tree["blocks"])],
        "final_norm": tree_map(leaf, tree["final_norm"]),
    }
    if "encoder" in tree:
        out["encoder"] = {"blocks": [entry("enc", tree["encoder"]["blocks"][0])],
                          "final_norm": tree_map(leaf, tree["encoder"]["final_norm"])}
    return out


def to_numpy(t: torch.Tensor) -> np.ndarray:
    """A tensor as numpy on the host; bf16 as ml_dtypes' bfloat16 (imported
    here only: the card's machine may not have it)."""
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def to_jax_layout(tree, cfg):
    """``to_reference_layout`` as numpy: the inverse of ``from_jax_params``
    (the tree ``jax.tree.map(np.asarray, params)`` of the reference's model
    with the same weights)."""
    return tree_map(to_numpy, to_reference_layout(tree, cfg, device="cpu"))


def reference_shapes(specs, cfg):
    """A ParamSpec tree of the model (``Model.param_specs()``) -> the same
    tree of shape tuples as the reference stacks each leaf: (n,) + shape in a
    program entry of n layers (and in whisper's encoder), (G, 4) + shape for
    a vision group's self layers, the shape itself for embed and final_norm."""
    def stacked(prefix):
        return lambda s: tuple(prefix) + tuple(s.shape)

    def layer(p, n):
        out = tree_map(stacked((n,)), p)
        if isinstance(p, dict) and isinstance(p.get("self"), list):
            out["self"] = [tree_map(stacked((n, len(p["self"]))), sp) for sp in p["self"]]
        return out

    out = {
        "embed": tree_map(stacked(()), specs["embed"]),
        "blocks": [[layer(p, len(layers)) for p in layers] for layers in specs["blocks"]],
        "final_norm": tree_map(stacked(()), specs["final_norm"]),
    }
    if "encoder" in specs:
        enc = specs["encoder"]["blocks"][0]
        out["encoder"] = {"blocks": [[layer(p, len(enc)) for p in enc]],
                          "final_norm": tree_map(stacked(()), specs["encoder"]["final_norm"])}
    return out
