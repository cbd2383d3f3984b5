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
groups' doubly stacked self layers. This module imports neither JAX nor
repro.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from repro_torch.kernels.common import resolve_device

from .transformer import VisGroup, block_program


def _tensor(a: Any, device: torch.device) -> torch.Tensor:
    a = np.array(a)  # a writable, contiguous copy
    if a.dtype.name == "bfloat16":  # ml_dtypes' bf16: reinterpret the bits
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def _map(tree, fn):
    if isinstance(tree, dict):
        return {k: _map(v, fn) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_map(v, fn) for v in tree]
    return fn(tree)


def _split(tree, n: int, device):
    """A stacked subtree -> ``n`` per-layer dicts on ``device``."""
    stacked = _map(tree, lambda a: _tensor(a, device))
    return [_map(stacked, lambda t, l=l: t[l]) for l in range(n)]


def from_jax_params(np_tree, cfg, device=None):
    """Port parameters from a numpy copy of the reference's parameter pytree
    for ``cfg``: every entry of ``block_program(cfg)`` (dense, moe, ssm, rec,
    rg_group with its nested {"rec0", "rec1", "attn"} stacks, dec, vis_group)
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
                p["self"] = [_map(p["self"], lambda t, i=i: t[i]) for i in range(VisGroup.N_SELF)]
        blocks.append(layers)
    out = {
        "embed": _map(np_tree["embed"], lambda a: _tensor(a, device)),
        "blocks": blocks,
        "final_norm": _map(np_tree["final_norm"], lambda a: _tensor(a, device)),
    }
    if "encoder" in np_tree:
        enc = np_tree["encoder"]
        out["encoder"] = {
            "blocks": [_split(enc["blocks"][0], cfg.n_enc_layers, device)],
            "final_norm": _map(enc["final_norm"], lambda a: _tensor(a, device)),
        }
    return out
