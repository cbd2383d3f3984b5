"""The model stack of the port: the dense, MoE, SSM, hybrid, encoder,
cross-attention decoder and vision block kinds, and Model.

Port of ``repro.models.transformer``. An architecture is a program of (block
kind, count) entries (``block_program``).
Parameters are plain nested dicts of tensors with the reference's leaf names
and weight layouts; where the reference stacks a leading layer dim and scans,
the port keeps one dict per layer (``params["blocks"][i][l]`` for program
entry i; whisper's encoder in ``params["encoder"]["blocks"][0][l]``; a vision
group's four self-attention layers as a list, ``p["self"][i]``) and loops.
Caches keep the stacked form: the dense decode cache
{"k", "v": (L, B, Hkv, S, Dh)} (S the window for a local-attention ring),
the SSM cache {"state": (L, B, H, P, N), "conv": (L, B, K - 1, conv_dim)},
the RG-LRU cache {"h": (L, B, W), "conv": (L, B, K - 1, W)}, a group's
nested {"rec0", "rec1", "attn"} of those, a cross-attention layer's {"self":
dense cache, "cross": the context's K/V}, a vision group's {"self": {"k",
"v": (G, 4, B, Hkv, S, Dh)}, "cross"}, the page pools (L, num_pages, Hkv,
ps, Dh) (or their {"q", "scale"} quantized form); per-layer views of them are
updated in place. ``Model(cfg, quant=...)`` stores the MLP (and expert) weights
through a QuantizedAccessor (int8 serving weights).

The encoder-decoder and vision families take their context (precomputed
frames or image embeddings: the frontends are stubs, as in the reference)
through ``prefill(batch_inputs=...)`` or ``ctx=``; the cross K/V live in the
decode caches, so ``decode_step`` takes no context. They run on the dense
cache only: the paged entry points refuse them, as the reference's do.

``attn_impl`` on forward / prefill / decode_step picks the kernels of the
dense-cache path (flash_attention, flash_decode, ssd_scan, rglru_scan:
"auto" | "cuda" | "torch", as kernels.ops), so an oracle can force the plain
versions.

On a mesh (the sharded train step: a ``Sharder`` and DTensor params) each
block kind's ``train`` runs its whole body, ``local``, on this rank's shards
in one ``local_map`` (``core.distributed.block_map``): the norms on the
replicated width, attention, the MLP, the MoE, the SSM and the RG-LRU split
over "model" with their collectives explicit (``LocalMesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Optional

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from repro_torch.kernels.common import resolve_device

from repro_torch.core.distributed import block_layout, block_map

from . import attention as attn
from . import moe as moe_mod
from . import rglru as rg_mod
from . import ssm as ssm_mod
from .layers import (
    NULL_SHARDER,
    ParamSpec,
    apply_embed,
    apply_lm_head,
    apply_mlp,
    apply_norm,
    cross_entropy,
    embed_specs,
    init_tree,
    mlp_specs,
    norm_specs,
)


def _layout(blk, cfg, p, x, shard):
    """The block map's layout for a layer of ``blk`` (``block_layout``, with
    ``blk.whole`` / ``blk.partial`` naming the leaves taken whole on "model"
    and those whose gradient a rank holds a part of): the same for every
    layer of a kind, so the Sharder keeps it."""
    key = (blk, cfg, tuple(x.placements))
    layout = shard.layouts.get(key)
    if layout is None:
        layout = shard.layouts[key] = block_layout(shard.mesh, x, p, whole=blk.whole(p),
                                                   partial=blk.partial(p))
    return layout


def _mapped(blk, cfg, p, x, impl, ctx, shard):
    """``blk.local`` in one block map on ``shard``'s mesh (x and p DTensors,
    ctx too where the kind attends to it), its layout kept (``_layout``)."""
    extras = (ctx,) if blk.USES_CTX else ()
    kw = dict(layout=_layout(blk, cfg, p, x, shard))
    if blk.AUX:
        return block_map(lambda lm, x_, p_, *c: blk.local(cfg, p_, x_, lm, impl, *c),
                         shard.mesh, x, p, extras, aux=True, **kw)
    return block_map(lambda lm, x_, p_, *c: blk.local(cfg, p_, x_, lm, impl, *c)[0],
                     shard.mesh, x, p, extras, **kw), 0.0


class _Block:
    """What every kind's ``train`` shares: off a mesh, ``local`` on the
    plain tensors; on one (``shard`` active, x and p DTensors), ``local`` on
    this rank's shards inside one block map (``_mapped``), whose
    collectives are the body's own. A kind's ``local(cfg, p, x, lm, impl[,
    ctx]) -> (x, aux)`` is its whole body (``lm`` None off a mesh); ``AUX``
    says its aux is a tensor (the MoE's router loss), ``USES_CTX`` that it
    attends to the cross-attention context, and ``whole(p)`` /
    ``partial(p)`` name its leaves for the block map (paths under p)."""

    AUX = False
    USES_CTX = False

    def whole(self, p) -> set:
        return set()

    def partial(self, p) -> set:
        return set()

    def train(self, cfg, p, x, impl="auto", ctx=None, shard=NULL_SHARDER):
        """-> (x, aux): aux the layer's router loss (0 without experts)."""
        if shard.active(x):
            return _mapped(self, cfg, p, x, impl, ctx, shard)
        return self.local(cfg, p, x, None, impl, *((ctx,) if self.USES_CTX else ()))


class DenseBlock(_Block):
    """Pre-norm self-attention (+ a local window for ``use_window``, the
    hybrid family's local_attn kind; non-causal for ``causal=False``, the
    whisper encoder's enc kind) + MLP; decode and the paged paths write one
    layer's cache or page pool in place. Every kind's train / prefill take
    ``ctx`` (the cross-attention context) and ignore it unless they attend
    to it."""

    def __init__(self, use_window: bool = False, causal: bool = True):
        self.use_window = use_window
        self.causal = causal

    def _window(self, cfg):
        return cfg.window if self.use_window else None

    @staticmethod
    def specs(cfg, quant=None):
        return {
            "ln_attn": norm_specs(cfg),
            "attn": attn.attn_specs(cfg),
            "ln_mlp": norm_specs(cfg),
            "mlp": mlp_specs(cfg, quant=quant),
        }

    def cache_specs(self, cfg, batch: int, seq: int):
        w = self._window(cfg)
        return attn.cache_specs(cfg, batch, min(seq, w) if w is not None else seq)

    @staticmethod
    def _mlp(cfg, p, x, lm=None):
        return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, x, p["ln_mlp"]), lm)

    @classmethod
    def _mlp_aux(cls, cfg, p, x, lm=None):
        return cls._mlp(cfg, p, x, lm), 0.0

    def partial(self, p, prefix: str = "") -> set:
        return attn.attn_partial(p["attn"], prefix + "attn/")

    def local(self, cfg, p, x, lm, impl="auto"):
        """The block's body: the norms run on the whole (replicated) width,
        attention and the MLP split over "model" inside a block map."""
        h = apply_norm(cfg, x, p["ln_attn"])
        x = x + attn.self_attention(cfg, p["attn"], h, lm=lm, causal=self.causal,
                                    window=self._window(cfg), impl=impl)
        return self._mlp_aux(cfg, p, x, lm)

    def prefill(self, cfg, p, x, max_len=None, impl="auto", ctx=None, lm=None):
        """-> (x, the layer's cache); inside a serving block map (``lm``) the
        cache is whole on "model" (every kv head under ``serve_rules``) and
        the rank's rows: ``Model`` keeps each rank's block of it."""
        h = apply_norm(cfg, x, p["ln_attn"])
        w = self._window(cfg)
        y, (k, v) = attn.self_attention(cfg, p["attn"], h, lm=lm, causal=self.causal, window=w,
                                        return_kv=True, impl=impl)
        x = self._mlp(cfg, p, x + y, lm)
        return x, attn.pack_kv_cache(cfg, k, v, max_len=max_len, window=w)

    def decode(self, cfg, p, x, cache, pos, impl="auto", lm=None, seq_split=False):
        """One token against the layer's cache, in place; ``seq_split``: the
        cache is this rank's slice of S (``self_attention_decode``)."""
        h = apply_norm(cfg, x, p["ln_attn"])
        y, cache = attn.self_attention_decode(cfg, p["attn"], h, cache, pos,
                                              window=self._window(cfg), impl=impl, lm=lm,
                                              seq_split=bool(seq_split))
        return self._mlp(cfg, p, x + y, lm), cache

    @classmethod
    def decode_paged(cls, cfg, p, x, cache, block_tables, context_lens, kv_spec=None,
                     block_pages=None, lm=None):
        h = apply_norm(cfg, x, p["ln_attn"])
        y, _ = attn.self_attention_decode_paged(
            cfg, p["attn"], h, cache, block_tables, context_lens, kv_spec=kv_spec,
            block_pages=block_pages, lm=lm,
        )
        return cls._mlp(cfg, p, x + y, lm)

    @classmethod
    def prefill_chunk_paged(cls, cfg, p, x, cache, block_tables, write_tables,
                            cursors, n_new, kv_spec=None, lm=None):
        h = apply_norm(cfg, x, p["ln_attn"])
        y, _ = attn.self_attention_prefill_chunk_paged(
            cfg, p["attn"], h, cache, block_tables, write_tables, cursors, n_new,
            kv_spec=kv_spec, lm=lm,
        )
        return cls._mlp(cfg, p, x + y, lm)

    @classmethod
    def verify_paged(cls, cfg, p, x, cache, block_tables, context_lens, kv_spec=None,
                     lm=None):
        h = apply_norm(cfg, x, p["ln_attn"])
        y, _ = attn.self_attention_verify_paged(
            cfg, p["attn"], h, cache, block_tables, context_lens, kv_spec=kv_spec, lm=lm,
        )
        return cls._mlp(cfg, p, x + y, lm)


class MoEBlock(DenseBlock):
    """DenseBlock with the MoE in the MLP's place (keys ``ln_moe`` / ``moe``):
    every path of DenseBlock, paged ones included, runs with it; only
    ``train`` keeps the router's aux loss, the serving paths drop it."""

    @staticmethod
    def specs(cfg, quant=None):
        return {
            "ln_attn": norm_specs(cfg),
            "attn": attn.attn_specs(cfg),
            "ln_moe": norm_specs(cfg),
            "moe": moe_mod.moe_specs(cfg, quant=quant),
        }

    AUX = True

    def partial(self, p, prefix: str = "") -> set:
        return super().partial(p, prefix) | moe_mod.moe_partial(p["moe"], prefix + "moe/")

    @staticmethod
    def _mlp_aux(cfg, p, x, lm=None):
        y, aux = moe_mod.moe_local(cfg, p["moe"], apply_norm(cfg, x, p["ln_moe"]), lm)
        return x + y, aux

    @classmethod
    def _mlp(cls, cfg, p, x, lm=None):
        return cls._mlp_aux(cfg, p, x, lm)[0]


class SSMBlock(_Block):
    """Pre-norm Mamba-2 mixer (no MLP); decode updates one layer's state and
    conv rows in place."""

    @staticmethod
    def specs(cfg, quant=None):
        return {"ln": norm_specs(cfg), "ssm": ssm_mod.ssm_specs(cfg, quant=quant)}

    @staticmethod
    def cache_specs(cfg, batch: int, seq: int):
        return ssm_mod.ssm_cache_specs(cfg, batch)

    def whole(self, p) -> set:
        return ssm_mod.ssm_whole(p["ssm"], "ssm/")

    def partial(self, p) -> set:
        return ssm_mod.ssm_partial(p["ssm"], "ssm/")

    @staticmethod
    def local(cfg, p, x, lm, impl="auto"):
        return x + ssm_mod.apply_ssm(cfg, p["ssm"], apply_norm(cfg, x, p["ln"]), lm=lm,
                                     impl=impl), 0.0

    @staticmethod
    def prefill(cfg, p, x, max_len=None, impl="auto", ctx=None, lm=None):
        h = apply_norm(cfg, x, p["ln"])
        y, cache = ssm_mod.apply_ssm(cfg, p["ssm"], h, lm=lm, return_state=True, impl=impl)
        return x + y, cache

    @staticmethod
    def decode(cfg, p, x, cache, pos, impl="auto", lm=None, seq_split=None):
        y, new = ssm_mod.apply_ssm_decode(cfg, p["ssm"], apply_norm(cfg, x, p["ln"]), cache, pos,
                                          lm=lm)
        for name, t in new.items():
            cache[name].copy_(t)
        return x + y, cache


class RecBlock(_Block):
    """Pre-norm RG-LRU temporal block + gated MLP; decode updates one layer's
    state and conv rows in place."""

    @staticmethod
    def specs(cfg, quant=None):
        return {
            "ln_rec": norm_specs(cfg),
            "rec": rg_mod.rglru_specs(cfg, quant=quant),
            "ln_mlp": norm_specs(cfg),
            "mlp": mlp_specs(cfg, quant=quant),
        }

    @staticmethod
    def cache_specs(cfg, batch: int, seq: int):
        return rg_mod.rglru_cache_specs(cfg, batch)

    def whole(self, p, prefix: str = "") -> set:
        return rg_mod.rglru_whole(p["rec"], prefix + "rec/")

    def partial(self, p, prefix: str = "") -> set:
        return rg_mod.rglru_partial(p["rec"], prefix + "rec/")

    @staticmethod
    def local(cfg, p, x, lm, impl="auto"):
        x = x + rg_mod.apply_rglru(cfg, p["rec"], apply_norm(cfg, x, p["ln_rec"]), lm=lm,
                                   impl=impl)
        return DenseBlock._mlp(cfg, p, x, lm), 0.0

    @staticmethod
    def prefill(cfg, p, x, max_len=None, impl="auto", ctx=None, lm=None):
        h = apply_norm(cfg, x, p["ln_rec"])
        y, cache = rg_mod.apply_rglru(cfg, p["rec"], h, lm=lm, return_state=True, impl=impl)
        return DenseBlock._mlp(cfg, p, x + y, lm), cache

    @staticmethod
    def decode(cfg, p, x, cache, pos, impl="auto", lm=None, seq_split=None):
        h = apply_norm(cfg, x, p["ln_rec"])
        y, cache = rg_mod.apply_rglru_decode(cfg, p["rec"], h, cache, pos, lm=lm)
        return DenseBlock._mlp(cfg, p, x + y, lm), cache


class RGGroup(_Block):
    """RecurrentGemma's repeating unit: [rec, rec, local_attn], with nested
    {"rec0", "rec1", "attn"} parameters and caches; on a mesh the three run
    in the group's one block map."""

    PARTS = (("rec0", RecBlock()), ("rec1", RecBlock()), ("attn", DenseBlock(use_window=True)))

    def specs(self, cfg, quant=None):
        return {name: blk.specs(cfg, quant) for name, blk in self.PARTS}

    def cache_specs(self, cfg, batch: int, seq: int):
        return {name: blk.cache_specs(cfg, batch, seq) for name, blk in self.PARTS}

    def whole(self, p) -> set:
        return set().union(*(blk.whole(p[name], name + "/") for name, blk in self.PARTS
                             if isinstance(blk, RecBlock)))

    def partial(self, p) -> set:
        return set().union(*(blk.partial(p[name], name + "/") for name, blk in self.PARTS))

    def local(self, cfg, p, x, lm, impl="auto"):
        for name, blk in self.PARTS:
            x, _ = blk.local(cfg, p[name], x, lm, impl)
        return x, 0.0

    def prefill(self, cfg, p, x, max_len=None, impl="auto", ctx=None, lm=None):
        caches = {}
        for name, blk in self.PARTS:
            x, caches[name] = blk.prefill(cfg, p[name], x, max_len=max_len, impl=impl, lm=lm)
        return x, caches

    def decode(self, cfg, p, x, cache, pos, impl="auto", lm=None, seq_split=None):
        for name, blk in self.PARTS:
            x, _ = blk.decode(cfg, p[name], x, cache[name], pos, impl=impl, lm=lm,
                              seq_split=(seq_split or {}).get(name))
        return x, cache


def _cross_cache(cfg, k, v):
    """A cross-attention layer's cache: the context's K/V in the param dtype."""
    return {"k": k.to(cfg.param_dtype), "v": v.to(cfg.param_dtype)}


class DecBlock(_Block):
    """Whisper's decoder layer: pre-norm causal self-attention,
    cross-attention over the encoder's output, then the MLP. Its cache is
    {"self": the dense decode cache, "cross": the context's K/V (B, Hkv,
    enc_seq, Dh)}, the cross half written once, at prefill."""

    @staticmethod
    def specs(cfg, quant=None):
        return {
            "ln_self": norm_specs(cfg),
            "self": attn.attn_specs(cfg),
            "ln_cross": norm_specs(cfg),
            "cross": attn.cross_attn_specs(cfg),
            "ln_mlp": norm_specs(cfg),
            "mlp": mlp_specs(cfg, quant=quant),
        }

    @staticmethod
    def cache_specs(cfg, batch: int, seq: int):
        return {"self": attn.cache_specs(cfg, batch, seq),
                "cross": attn.cache_specs(cfg, batch, cfg.enc_seq)}

    USES_CTX = True

    def partial(self, p) -> set:
        return attn.attn_partial(p["self"], "self/") | attn.attn_partial(p["cross"], "cross/")

    @staticmethod
    def local(cfg, p, x, lm, impl="auto", ctx=None):
        x = x + attn.self_attention(cfg, p["self"], apply_norm(cfg, x, p["ln_self"]), lm=lm,
                                    impl=impl)
        h = apply_norm(cfg, x, p["ln_cross"])
        x = x + attn.cross_attention(cfg, p["cross"], h, ctx, lm=lm, impl=impl)
        return DenseBlock._mlp(cfg, p, x, lm), 0.0

    @staticmethod
    def prefill(cfg, p, x, max_len=None, impl="auto", ctx=None, lm=None):
        h = apply_norm(cfg, x, p["ln_self"])
        y, (k, v) = attn.self_attention(cfg, p["self"], h, lm=lm, return_kv=True, impl=impl)
        x = x + y
        h = apply_norm(cfg, x, p["ln_cross"])
        y, (ck, cv) = attn.cross_attention(cfg, p["cross"], h, ctx, lm=lm, return_kv=True,
                                           impl=impl)
        return DenseBlock._mlp(cfg, p, x + y, lm), {
            "self": attn.pack_kv_cache(cfg, k, v, max_len=max_len),
            "cross": _cross_cache(cfg, ck, cv)}

    @staticmethod
    def decode(cfg, p, x, cache, pos, impl="auto", lm=None, seq_split=None):
        sp = seq_split or {}
        h = apply_norm(cfg, x, p["ln_self"])
        y, _ = attn.self_attention_decode(cfg, p["self"], h, cache["self"], pos, impl=impl, lm=lm,
                                          seq_split=bool(sp.get("self")))
        x = x + y
        h = apply_norm(cfg, x, p["ln_cross"])
        kv = (cache["cross"]["k"], cache["cross"]["v"])
        x = x + attn.cross_attention_decode(cfg, p["cross"], h, kv, impl=impl, lm=lm,
                                            seq_split=bool(sp.get("cross")))
        return DenseBlock._mlp(cfg, p, x, lm), cache


def _stack_specs(specs, n: int):
    """A (nested) dict of ParamSpecs with a leading dim ``n`` on each (the
    logical axis "layers", replicated)."""
    if isinstance(specs, dict):
        return {k: _stack_specs(v, n) for k, v in specs.items()}
    return dataclasses.replace(specs, shape=(n,) + specs.shape,
                               logical_axes=("layers",) + specs.axes)


class VisGroup(_Block):
    """llama-3.2-vision's unit: N_SELF dense self-attention layers, then a
    gated cross-attention layer over the image embeddings and the MLP. The
    gate, tanh of a learned f32 scalar cast to x's dtype, scales the
    cross-attention output only. The params keep the self layers as a list
    (``p["self"][i]``); the cache stacks them: {"self": {"k", "v": (N_SELF,
    B, Hkv, S, Dh)}, "cross": {"k", "v": (B, Hkv, n_img_tokens, Dh)}}. The
    gate starts at 0 (the reference's init), where tanh(0) erases the cross
    layer: a check of the cross path must set it."""

    N_SELF = 4
    DENSE = DenseBlock()

    def specs(self, cfg, quant=None):
        return {
            "self": [self.DENSE.specs(cfg, quant) for _ in range(self.N_SELF)],
            "ln_cross": norm_specs(cfg),
            "cross": attn.cross_attn_specs(cfg),
            "gate": ParamSpec((), torch.float32, "zeros", logical_axes=()),
            "ln_mlp": norm_specs(cfg),
            "mlp": mlp_specs(cfg, quant=quant),
        }

    def cache_specs(self, cfg, batch: int, seq: int):
        return {"self": _stack_specs(self.DENSE.cache_specs(cfg, batch, seq), self.N_SELF),
                "cross": attn.cache_specs(cfg, batch, cfg.n_img_tokens)}

    USES_CTX = True

    @staticmethod
    def _gated(cfg, p, x, y, lm=None):
        return DenseBlock._mlp(cfg, p, x + torch.tanh(p["gate"]).to(x.dtype) * y, lm)

    def partial(self, p) -> set:
        return set().union(attn.attn_partial(p["cross"], "cross/"),
                           *(self.DENSE.partial(pl, f"self/{i}/")
                             for i, pl in enumerate(p["self"])))

    def local(self, cfg, p, x, lm, impl="auto", ctx=None):
        """The group's body: its self layers, the gated cross layer (the gate
        a replicated scalar) and the MLP, in one block map on a mesh."""
        for pl in p["self"]:
            x, _ = self.DENSE.local(cfg, pl, x, lm, impl)
        h = apply_norm(cfg, x, p["ln_cross"])
        y = attn.cross_attention(cfg, p["cross"], h, ctx, lm=lm, impl=impl)
        return self._gated(cfg, p, x, y, lm), 0.0

    def prefill(self, cfg, p, x, max_len=None, impl="auto", ctx=None, lm=None):
        caches = []
        for pl in p["self"]:
            x, c = self.DENSE.prefill(cfg, pl, x, max_len=max_len, impl=impl, lm=lm)
            caches.append(c)
        h = apply_norm(cfg, x, p["ln_cross"])
        y, (ck, cv) = attn.cross_attention(cfg, p["cross"], h, ctx, lm=lm, return_kv=True,
                                           impl=impl)
        return self._gated(cfg, p, x, y, lm), {"self": _stack(caches),
                                              "cross": _cross_cache(cfg, ck, cv)}

    def decode(self, cfg, p, x, cache, pos, impl="auto", lm=None, seq_split=None):
        sp = seq_split or {}
        for i, pl in enumerate(p["self"]):
            x, _ = self.DENSE.decode(cfg, pl, x, _layer(cache["self"], i), pos, impl=impl, lm=lm,
                                     seq_split=sp.get("self"))
        h = apply_norm(cfg, x, p["ln_cross"])
        kv = (cache["cross"]["k"], cache["cross"]["v"])
        y = attn.cross_attention_decode(cfg, p["cross"], h, kv, impl=impl, lm=lm,
                                        seq_split=bool(sp.get("cross")))
        return self._gated(cfg, p, x, y, lm), cache


KINDS = {
    "dense": DenseBlock(),
    "moe": MoEBlock(),
    "local_attn": DenseBlock(use_window=True),
    "enc": DenseBlock(causal=False),
    "ssm": SSMBlock(),
    "rec": RecBlock(),
    "rg_group": RGGroup(),
    "dec": DecBlock(),
    "vis_group": VisGroup(),
}


def block_program(cfg):
    """The architecture as (block kind, count) entries, as in the reference.
    The hybrid family is n_layers // len(pattern) groups (kept when that is
    0, as the reference keeps it) and the remainder as rec blocks; the vlm
    family n_layers // 5 vision groups (n_layers must divide); encdec
    n_layers decoder layers (the encoder is not a program entry)."""
    if cfg.family == "dense":
        return [("dense", cfg.n_layers)]
    if cfg.family == "moe":
        return [("moe", cfg.n_layers)]
    if cfg.family == "ssm":
        return [("ssm", cfg.n_layers)]
    if cfg.family == "hybrid":
        n_groups, rem = divmod(cfg.n_layers, len(cfg.pattern))
        prog = [("rg_group", n_groups)]
        if rem:
            prog.append(("rec", rem))
        return prog
    if cfg.family == "vlm":
        assert cfg.n_layers % (VisGroup.N_SELF + 1) == 0, cfg.n_layers
        return [("vis_group", cfg.n_layers // (VisGroup.N_SELF + 1))]
    if cfg.family == "encdec":
        return [("dec", cfg.n_layers)]
    raise ValueError(cfg.family)


_SAVED_BY_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    """The "dots" remat policy: keep every matmul's output, recompute the rest."""
    return CheckpointPolicy.MUST_SAVE if op in _SAVED_BY_DOTS else \
        CheckpointPolicy.PREFER_RECOMPUTE


def _remat(remat: bool, policy: Optional[str]):
    """How ``forward`` runs one layer: directly, or under a non-reentrant
    ``torch.utils.checkpoint`` that keeps nothing (policy None / "nothing")
    or the matmul outputs ("dots")."""
    if policy not in (None, "nothing", "dots"):
        raise ValueError(f"remat_policy must be None, 'nothing' or 'dots', got {policy!r}")
    if not remat or not torch.is_grad_enabled():
        return lambda fn, *args, **kw: fn(*args, **kw)
    kw = {}
    if policy == "dots":
        kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _dots_policy)
    return lambda fn, *args, **fkw: checkpoint(fn, *args, use_reentrant=False, **kw, **fkw)


def _sinusoidal(t: int, d: int, device=None) -> torch.Tensor:
    """(t, d) f32 position table: [sin | cos] halves (not interleaved) of
    pos / 10000^(2i / d), as the reference's."""
    pos = torch.arange(t, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / torch.pow(10000.0, 2 * dim / d)
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _layer(tree, l: int):
    """Layer ``l``'s view of a stacked cache or pool dict (nested for
    quantized pools)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


def _seq_splits(tree):
    """For a DTensor cache tree: each {"k", "v"} dict -> whether its S dim
    (the second last) is split over "model" (the sharded decode applies),
    any other leaf -> None."""
    from repro_torch.core.distributed import is_split

    if isinstance(tree, dict):
        if set(tree) == {"k", "v"} and not isinstance(tree["k"], dict):
            return is_split(tree["k"], tree["k"].dim() - 2)
        return {n: _seq_splits(t) for n, t in tree.items()}
    return None


@contextlib.contextmanager
def _on_mesh(shard):
    """Where serving runs on ``shard``'s mesh: no grad, and plain tensors
    mixed with DTensors (RoPE tables, the gemma scale, masks) read as
    replicated. Nothing off a mesh."""
    if shard.mesh is None:
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with torch.no_grad(), implicit_replication():
        yield


def _stack(layers: List[Dict]) -> Dict:
    """Per-layer cache dicts (nested for a group) -> one dict of stacked (L,
    ...) tensors."""
    return {k: _stack([c[k] for c in layers]) if isinstance(layers[0][k], dict)
            else torch.stack([c[k] for c in layers]) for k in layers[0]}


class Model:
    """A dense (GQA), MoE, SSM (Mamba-2), hybrid (recurrentgemma),
    encoder-decoder (whisper) or vision (llama-3.2-vision) model on one
    device. ``device`` defaults to CUDA and raises without a GPU; pass
    ``device="cpu"`` to run the plain versions. ``quant`` (core.QuantizedAccessor) stores the MLP
    weights quantized, as the reference's serving-weight accessor."""

    def __init__(self, cfg, quant=None, device=None):
        block_program(cfg)  # refuses an unknown family
        self.cfg = cfg
        self.quant = quant
        self.device = resolve_device(device)

    def _program(self, params):
        """(block class, its per-layer params) for each program entry."""
        return [(KINDS[kind], p) for (kind, _), p in zip(block_program(self.cfg),
                                                         params["blocks"])]

    # ---- specs / init --------------------------------------------------------------
    def param_specs(self):
        """{"embed", "blocks": [[layer specs] * count per program entry],
        "final_norm"}, and for encdec "encoder": {"blocks": [[enc layer specs]
        * n_enc_layers], "final_norm"}, as the reference's tree."""
        cfg = self.cfg
        specs = {
            "embed": embed_specs(cfg),
            "blocks": [[KINDS[kind].specs(cfg, self.quant) for _ in range(n)]
                       for kind, n in block_program(cfg)],
            "final_norm": norm_specs(cfg),
        }
        if cfg.family == "encdec":
            enc_cfg = dataclasses.replace(cfg, mlp_act="gelu")
            specs["encoder"] = {
                "blocks": [[KINDS["enc"].specs(enc_cfg, self.quant)
                            for _ in range(cfg.n_enc_layers)]],
                "final_norm": norm_specs(cfg),
            }
        return specs

    def init_params(self, generator: torch.Generator, device=None):
        """Random parameters from ``generator`` (which must live on the target
        device) with the reference's init scheme."""
        return init_tree(self.param_specs(), generator, device or self.device)

    def cache_specs(self, batch: int, seq: int):
        """One layer's decode-cache specs per program entry (the caches stack
        a leading layer dim on each)."""
        return [KINDS[kind].cache_specs(self.cfg, batch, seq)
                for kind, _ in block_program(self.cfg)]

    def _zeros(self, spec, n: int):
        """Zeroed tensors with a leading layer dim ``n`` for a (nested) spec dict."""
        if isinstance(spec, dict):
            return {k: self._zeros(v, n) for k, v in spec.items()}
        return torch.zeros((n,) + spec.shape, dtype=spec.dtype, device=self.device)

    def init_cache(self, batch: int, seq: int) -> List[Dict]:
        """Zeroed decode caches with the leading layer dim, one (nested) dict
        per program entry (the layout ``prefill(max_len=seq)`` returns)."""
        return [self._zeros(specs, n)
                for specs, (_, n) in zip(self.cache_specs(batch, seq), block_program(self.cfg))]

    def _paged_only_dense(self) -> None:
        for kind, _ in block_program(self.cfg):
            if kind not in ("dense", "moe"):
                raise NotImplementedError(
                    f"paged KV caching supports dense-attention blocks; got {kind!r}"
                )

    def paged_cache_specs(self, num_pages: int, page_size: int, kv_spec=None):
        self._paged_only_dense()
        return [attn.paged_cache_specs(self.cfg, num_pages, page_size, kv_spec=kv_spec)]

    def init_paged_cache(self, num_pages: int, page_size: int, kv_spec=None) -> List[Dict]:
        """Zeroed page pools, one {"k", "v"} dict per block-program entry with a
        leading layer dim: (L, num_pages, Hkv, ps, Dh), or with ``kv_spec``
        {"q": (L, num_pages, Hkv, ps, Dq) int8, "scale": (L, num_pages, Hkv)}
        for each of k and v."""
        return [self._zeros(entry, self.cfg.n_layers)
                for entry in self.paged_cache_specs(num_pages, page_size, kv_spec)]

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        x = apply_embed(params["embed"], tokens)
        if self.cfg.family == "hybrid":  # gemma convention: an f32 sqrt cast to x's dtype
            x = x * torch.tensor(float(self.cfg.d_model)).sqrt().to(x.dtype)
        return x

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.cfg, x, params["final_norm"])
        return apply_lm_head(self.cfg, params["embed"], x)

    # ---- context (stub frontends) ----------------------------------------------------
    def encode_ctx(self, params, batch: Dict[str, torch.Tensor], *, attn_impl: str = "auto",
                   shard=NULL_SHARDER):
        """The cross-attention context: for whisper the encoder over
        ``batch["frames"]`` (B, enc_seq, D) precomputed frame embeddings, plus
        the f32 sinusoidal table cast to their dtype, through n_enc_layers
        non-causal layers (RoPE at positions 0..T-1 on top, as the
        reference's self-attention applies it) and the final norm; for vlm
        ``batch["image_embeds"]`` as given; None otherwise."""
        cfg = self.cfg
        if cfg.family == "encdec":
            frames = batch["frames"]
            if shard.mesh is not None:  # a serving batch, whole on every rank
                frames = shard.place(frames, "batch", None, None)
            x = frames + _sinusoidal(frames.shape[1], cfg.d_model,
                                     frames.device).to(frames.dtype)[None]
            enc_cfg = dataclasses.replace(cfg, mlp_act="gelu")
            for p in params["encoder"]["blocks"][0]:
                x, _ = KINDS["enc"].train(enc_cfg, p, x, impl=attn_impl, shard=shard)
            return apply_norm(cfg, x, params["encoder"]["final_norm"])
        if cfg.family == "vlm":
            return batch["image_embeds"]
        return None

    # ---- full-sequence forward -------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, *, ctx=None, attn_impl: str = "auto",
                remat: bool = False, remat_policy: Optional[str] = None, shard=NULL_SHARDER):
        """tokens (B, T) -> (logits (B, T, Vp), aux): aux the f32 sum of the MoE
        layers' aux losses in layer order (0 for the other blocks). ``ctx``:
        the cross-attention context (``encode_ctx``) for encdec / vlm.

        ``remat`` recomputes each layer in the backward instead of keeping its
        activations (the reference's per-layer ``jax.checkpoint``:
        ``torch.utils.checkpoint`` without reentry); ``remat_policy`` "dots"
        keeps the outputs of the layer's matmuls (``aten.mm`` / ``aten.bmm``)
        and recomputes the rest, None or "nothing" keeps nothing. Without
        grad mode it changes nothing.

        On a mesh (``shard`` a Sharder, tokens and params DTensors) the
        activations are laid out ("batch", "seq", None) after the embedding
        and the logits ("batch", "seq", "vocab"), as the reference's, and
        each block runs on local shards in one block map (``_Block.train``):
        remat wraps the mapped block, so its FSDP gathers are redone in the
        backward, as the reference's ``jax.checkpoint`` redoes them."""
        x = shard(self._embed(params, tokens), "batch", "seq", None)
        aux = torch.zeros((), device=x.device)
        run = _remat(remat, remat_policy)
        for blk, layers in self._program(params):
            for p in layers:
                x, a = run(blk.train, self.cfg, p, x, impl=attn_impl, ctx=ctx, shard=shard)
                aux = aux + a
        return shard(self._head(params, x), "batch", "seq", "vocab"), aux

    def loss_fn(self, params, batch: Dict[str, torch.Tensor], *, remat: bool = True,
                remat_policy: Optional[str] = None, aux_weight: float = 0.01,
                attn_impl: str = "auto", shard=NULL_SHARDER):
        """The training loss, as the reference's: next-token CE of
        ``forward(tokens[:, :-1])`` against ``tokens[:, 1:]`` (``batch["mask"]``
        weighting positions when given), the context encoded first for encdec
        / vlm (``batch["frames"]`` / ``batch["image_embeds"]``), plus
        ``aux_weight`` times the MoE aux loss. -> (loss, {"ce", "aux"}).

        Every family trains on the card: the scans through their autograd
        Functions (``ssd_scan.SSDScanFn``, ``rglru_scan.RGLRUScanFn``: the
        forward kernels and their hand-written backward kernels), attention
        through ``flash_vjp.FlashAttentionFn``. On the CPU every family trains
        through the plain versions, as the reference trains through its jnp
        twins."""
        tokens = batch["tokens"]
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        ctx = self.encode_ctx(params, batch, attn_impl=attn_impl, shard=shard)
        logits, aux = self.forward(params, inp, ctx=ctx, attn_impl=attn_impl, remat=remat,
                                   remat_policy=remat_policy, shard=shard)
        loss = cross_entropy(logits, labels, batch.get("mask"))
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}

    # ---- serving on a mesh ------------------------------------------------------------
    def _head_mesh(self, params, x, shard, last=None, index=None):
        """The final norm and the LM head in one block map on ``shard``'s mesh,
        the logits gathered whole: the vocab's blocks over "model" inside the
        map, the batch's shards after it (``full_tensor``), so the sampler,
        ``top_logprobs`` and ``record_logits`` read whole (B, T', Vp) rows,
        a plain tensor, the same on every rank. ``last``: the one row of T
        read (an int); ``index`` (B,): each row's own (a whole-batch
        tensor)."""
        from .attention import _rows

        cfg = self.cfg
        hp = {"final_norm": params["final_norm"], "embed": params["embed"]}

        def body(lm, x_, p_):
            if last is not None:
                x_ = x_[:, last:last + 1]
            elif index is not None:
                rows = torch.arange(x_.shape[0], device=x_.device)
                x_ = x_[rows, _rows(lm, index).long()][:, None]
            h = apply_norm(cfg, x_, p_["final_norm"])
            w = p_["embed"]["embedding"].t() if cfg.tie_embeddings else p_["embed"]["lm_head"]
            logits = torch.matmul(h, w.to(h.dtype))
            if logits.shape[-1] < cfg.vocab_padded:
                logits = lm.gather(logits.contiguous(), logits.dim() - 1)
            vp = logits.shape[-1]
            if vp != cfg.vocab:
                mask = torch.arange(vp, device=logits.device) < cfg.vocab
                logits = torch.where(mask, logits, torch.full_like(logits, -1e9))
            return logits

        return block_map(body, shard.mesh, x, hp).full_tensor()

    def _mapped_serve(self, blk, p, x, shard, body, ctx=None):
        """``body(lm, x_local, p_local[, ctx_local])`` of one layer of ``blk``
        in one block map under no grad, its layout kept (``_layout``)."""
        extras = (ctx,) if blk.USES_CTX and ctx is not None else ()
        return block_map(body, shard.mesh, x, p, extras,
                         layout=_layout(blk, self.cfg, p, x, shard))

    def _cache_layout(self, blk, x, shard):
        """(cut, place) for a program entry's caches on ``shard``'s mesh. A
        serving block map computes each layer's cache whole on "model" and
        holding the rank's rows; ``cut(cache)`` keeps the rank's block of it
        as the rules lay out its specs' logical axes (the dense cache its
        slice of S over "model" where S divides it, an SSM state its heads,
        an RG-LRU state its columns), layer by layer, so no layer's whole
        cache outlives its map; ``place(per_layer)`` stacks the blocks and
        wraps them as DTensors with a leading layer dim."""
        from torch.distributed.tensor import DTensor, Shard

        from repro_torch.core.distributed import is_spec
        from repro_torch.core.tree import tree_map

        mesh, rules = shard.mesh, shard.rules
        count = 1
        for i, pl in enumerate(x.placements):
            if isinstance(pl, Shard) and pl.dim == 0:
                count *= mesh.size(i)
        coord = mesh.get_coordinate()
        axes_of = blk.cache_specs(self.cfg, count, 1)  # the logical axes; shapes from the tensors
        shapes = {}

        def cut(spec, t):
            axes = spec.axes
            shape = list(t.shape)
            shape[axes.index("batch")] *= count
            shapes[id(spec)] = shape
            for i, pl in enumerate(rules.placements(axes, shape, mesh)):
                if isinstance(pl, Shard) and axes[pl.dim] != "batch":
                    n = t.shape[pl.dim] // mesh.size(i)
                    t = t.narrow(pl.dim, coord[i] * n, n)
            return t.contiguous()

        def place(per_layer, batch: int, seq: int):
            if per_layer:
                stacked = _stack(per_layer)
            else:  # an entry of no layers keeps its empty (0, ...) cache
                one = self._zeros(blk.cache_specs(self.cfg, batch // count, seq), 1)
                stacked = tree_map(lambda t: t[None][:0],
                                   tree_map(cut, axes_of, tree_map(lambda t: t[0], one),
                                            is_leaf=is_spec))

            def wrap(spec, t):
                shape = [len(per_layer)] + shapes[id(spec)]
                pls = rules.placements(("layers",) + spec.axes, shape, mesh)
                strides = [1] * len(shape)
                for d in range(len(shape) - 2, -1, -1):
                    strides[d] = strides[d + 1] * shape[d + 1]
                return DTensor.from_local(t, mesh, pls, run_check=False,
                                          shape=torch.Size(shape), stride=tuple(strides))

            return tree_map(wrap, axes_of, stacked, is_leaf=is_spec)

        return (lambda cache: tree_map(cut, axes_of, cache, is_leaf=is_spec)), place

    def _prefill_mesh(self, params, tokens, ctx, max_len, last_index, attn_impl, shard):
        cfg = self.cfg
        tokens = shard.place(tokens, "batch", None)
        x = self._embed(params, tokens)
        seq = max_len or tokens.shape[1]
        caches = []
        for blk, layers in self._program(params):
            per_layer = []
            cut, place = self._cache_layout(blk, x, shard)
            for p in layers:
                def body(lm, x_, p_, *c, blk=blk):
                    y, cache = blk.prefill(cfg, p_, x_, max_len=max_len, impl=attn_impl,
                                           ctx=c[0] if c else None, lm=lm)
                    per_layer.append(cut(cache))
                    return y

                x = self._mapped_serve(blk, p, x, shard, body, ctx)
            caches.append(place(per_layer, tokens.shape[0], seq))
        last = tokens.shape[1] - 1 if last_index is None else int(last_index)
        return self._head_mesh(params, x, shard, last=last), caches

    def _decode_mesh(self, params, caches, tokens, pos, attn_impl, shard):
        from repro_torch.core.distributed import local_tensor
        from repro_torch.core.tree import tree_map

        cfg = self.cfg
        x = self._embed(params, shard.place(tokens[:, None], "batch", None))
        for (blk, layers), cache in zip(self._program(params), caches):
            splits = _seq_splits(cache)
            loc = tree_map(local_tensor, cache)
            for l, p in enumerate(layers):
                def body(lm, x_, p_, blk=blk, c=_layer(loc, l)):
                    return blk.decode(cfg, p_, x_, c, pos, impl=attn_impl, lm=lm,
                                      seq_split=splits)[0]

                x = self._mapped_serve(blk, p, x, shard, body)
        return self._head_mesh(params, x, shard)[:, 0], caches

    # ---- serving ---------------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor, *, ctx=None, batch_inputs=None,
                max_len: Optional[int] = None, last_index=None, attn_impl: str = "auto",
                shard=NULL_SHARDER):
        """tokens (B, S) -> (logits (B, 1, Vp), caches). The logits are read at
        ``last_index`` (default: the last column) — the engine right-pads
        prompts to whole pages; leave it None for the SSM family, whose final
        state padding would pollute. caches: one dict per program entry,
        {"k", "v": (L, B, Hkv, max_len, Dh)} (dense) or {"state", "conv"} (ssm),
        {"self", "cross"} (dec, vis_group). ``ctx`` is the cross-attention
        context; without it, ``batch_inputs`` ({"frames"} or
        {"image_embeds"}) goes through ``encode_ctx`` first.

        On a mesh (``shard`` a Sharder, params the DTensor tree
        ``tree_distribute`` lays out by its rules; tokens and the context
        whole on every rank) the batch is placed over its axes, each layer
        runs in one block map under no grad (``_prefill_mesh``), the caches
        come back as DTensors laid out by the rules' cache axes (under
        ``serve_rules`` the dense cache split along S over "model" where S
        divides it, the scan states by heads or columns) and the logits
        whole on every rank (``_head_mesh``)."""
        if shard.mesh is not None:
            with _on_mesh(shard):
                if ctx is None and batch_inputs is not None:
                    ctx = self.encode_ctx(params, batch_inputs, attn_impl=attn_impl, shard=shard)
                return self._prefill_mesh(params, tokens, shard.place(ctx, "batch", None, None),
                                          max_len, last_index, attn_impl, shard)
        if ctx is None and batch_inputs is not None:
            ctx = self.encode_ctx(params, batch_inputs, attn_impl=attn_impl)
        x = self._embed(params, tokens)
        caches = []
        for blk, layers in self._program(params):
            per_layer = []
            for p in layers:
                x, c = blk.prefill(self.cfg, p, x, max_len=max_len, impl=attn_impl, ctx=ctx)
                per_layer.append(c)
            # an entry of no layers (the hybrid family's zero-count group)
            # keeps its empty (0, ...) cache, as the reference's scan does
            caches.append(_stack(per_layer) if per_layer else self._zeros(
                blk.cache_specs(self.cfg, tokens.shape[0], max_len or tokens.shape[1]), 0))
        if last_index is None:
            x_last = x[:, -1:]
        else:
            i = int(last_index)
            x_last = x[:, i:i + 1]
        logits = self._head(params, x_last)
        return logits, caches

    def decode_step(self, params, caches, tokens: torch.Tensor, pos, *,
                    attn_impl: str = "auto", shard=NULL_SHARDER):
        """One token per row against the dense-cache state prefill returned:
        tokens (B,) at position ``pos`` (an int or a one-element integer
        tensor on the model's device, the same for every row). The caches are
        updated in place and returned. An int ``pos`` at or past the capacity of
        a dense cache without a window raises ValueError. -> (logits (B, Vp),
        caches).

        On a mesh (``shard``; params and the caches ``prefill(shard=)``
        returned, tokens whole on every rank) each layer runs in one block
        map on the cache's local tensors (written in place): a dense cache
        split along S takes the sharded decode (``self_attention_decode``'s
        ``seq_split``). The logits come back whole on every rank."""
        if not isinstance(pos, torch.Tensor):
            pos = attn.DecodePos(int(pos), torch.full((1,), int(pos), dtype=torch.int32,
                                                      device=self.device))
        if shard.mesh is not None:
            with _on_mesh(shard):
                return self._decode_mesh(params, caches, tokens, pos, attn_impl, shard)
        x = self._embed(params, tokens[:, None])
        for (blk, layers), cache in zip(self._program(params), caches):
            for l, p in enumerate(layers):
                x, _ = blk.decode(self.cfg, p, x, _layer(cache, l), pos, impl=attn_impl)
        return self._head(params, x)[:, 0], caches

    def decode_step_paged(self, params, caches, tokens: torch.Tensor,
                          block_tables: torch.Tensor, context_lens: torch.Tensor, *,
                          kv_spec=None, write_tables=None, n_new=None,
                          last_index=None, active=None, spec_verify: bool = False,
                          block_pages=None, shard=NULL_SHARDER):
        """The mixed serving step; the page pools in ``caches`` are updated in
        place and returned.

        tokens (B,): one decode token per row; context_lens (B,) tokens already
        cached; ``active`` (B,) nulls inactive rows' table row and length on
        device, so their write lands in the null page 0.

        tokens (B, C): one prefill chunk per row (C a page multiple);
        context_lens is the chunk cursor, ``write_tables`` routes the chunk's
        K/V scatter, ``n_new`` (B,) its valid tokens, ``last_index`` (B,) the
        row whose logits come back.

        ``kv_spec`` (serving.engine.kvquant.PagedQuantSpec) says the pools are
        quantized: appends and chunk scatters quantize, attention runs the
        dequantizing kernels.

        ``spec_verify=True`` with tokens (B, C) is the speculative verify
        step: C = K + 1 rows of [current token, draft] appended and scored
        per layer (DenseBlock.verify_paged), context_lens the resident length
        (any alignment), ``active`` honored as in decode, and the lm_head
        applied to all C rows: it returns logits (B, C, Vp).

        Every layer runs the program entry's block (DenseBlock or MoEBlock):
        an MoE layer routes every row of the step, padding and inactive rows
        included, as the reference does.

        ``block_pages`` (decode only) is the tuned decode block-shape knob,
        forwarded to the paged decode attention (None = unblocked).

        On a mesh (``shard``; params DTensors, everything else whole on every
        rank, the pools each rank's copy of the whole pools, as
        ``serve_rules`` lay them out) each layer runs in one block map:
        every rank writes every row's K/V into its pools and attends its own
        rows (the batch split over its axes) with q's heads gathered; the
        logits come back whole on every rank.

        Returns (logits (B, Vp), caches)."""
        self._paged_only_dense()
        cfg = self.cfg
        chunk = tokens.dim() == 2 and not spec_verify
        if active is not None and not chunk:
            on = active > 0
            block_tables = torch.where(on[:, None], block_tables, torch.zeros_like(block_tables))
            context_lens = torch.where(on, context_lens, torch.zeros_like(context_lens))
        with _on_mesh(shard):
            return self._paged_layers(params, caches, tokens, block_tables, context_lens,
                                      kv_spec, write_tables, n_new, last_index, spec_verify,
                                      block_pages, shard)

    def _paged_layers(self, params, caches, tokens, block_tables, context_lens, kv_spec,
                      write_tables, n_new, last_index, spec_verify, block_pages, shard):
        """``decode_step_paged``'s layers and head, each layer in one block
        map on a mesh (its body the same call with the map's ``lm``)."""
        cfg = self.cfg
        chunk = tokens.dim() == 2 and not spec_verify
        mapped = shard.mesh is not None
        x = tokens if tokens.dim() == 2 else tokens[:, None]
        x = self._embed(params, shard.place(x, "batch", None) if mapped else x)
        blk = KINDS[block_program(cfg)[0][0]]

        def layer(lm, x_, p_, cache):
            if spec_verify:
                return blk.verify_paged(cfg, p_, x_, cache, block_tables, context_lens,
                                        kv_spec=kv_spec, lm=lm)
            if chunk:
                return blk.prefill_chunk_paged(cfg, p_, x_, cache, block_tables, write_tables,
                                               context_lens, n_new, kv_spec=kv_spec, lm=lm)
            return blk.decode_paged(cfg, p_, x_, cache, block_tables, context_lens,
                                    kv_spec=kv_spec, block_pages=block_pages, lm=lm)

        for l, p in enumerate(params["blocks"][0]):
            cache = _layer(caches[0], l)
            if mapped:
                x = self._mapped_serve(blk, p, x, shard,
                                       lambda lm, x_, p_, c=cache: layer(lm, x_, p_, c))
            else:
                x = layer(None, x, p, cache)
        if mapped:
            # the head's block map reads each row's requested position itself
            logits = self._head_mesh(params, x, shard, index=last_index if chunk else None)
            return (logits if spec_verify else logits[:, 0]), caches
        if spec_verify:
            # row j of the window decides draft j + 1 (the last row the bonus)
            return self._head(params, x), caches
        if chunk:
            # only each row's requested position pays the vocab matmul
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, last_index.long()][:, None]
        return self._head(params, x)[:, 0], caches

