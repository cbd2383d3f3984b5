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
"""
from __future__ import annotations

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

from . import attention as attn
from . import moe as moe_mod
from . import rglru as rg_mod
from . import ssm as ssm_mod
from .layers import (
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


class DenseBlock:
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
    def _mlp(cfg, p, x):
        return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, x, p["ln_mlp"]))

    @classmethod
    def _mlp_aux(cls, cfg, p, x):
        return cls._mlp(cfg, p, x), 0.0

    def train(self, cfg, p, x, impl="auto", ctx=None):
        """-> (x, aux): aux the layer's router loss (0 without experts)."""
        h = apply_norm(cfg, x, p["ln_attn"])
        x = x + attn.self_attention(cfg, p["attn"], h, causal=self.causal,
                                    window=self._window(cfg), impl=impl)
        return self._mlp_aux(cfg, p, x)

    def prefill(self, cfg, p, x, max_len=None, impl="auto", ctx=None):
        h = apply_norm(cfg, x, p["ln_attn"])
        w = self._window(cfg)
        y, (k, v) = attn.self_attention(cfg, p["attn"], h, causal=self.causal, window=w,
                                        return_kv=True, impl=impl)
        x = self._mlp(cfg, p, x + y)
        return x, attn.pack_kv_cache(cfg, k, v, max_len=max_len, window=w)

    def decode(self, cfg, p, x, cache, pos, impl="auto"):
        h = apply_norm(cfg, x, p["ln_attn"])
        y, cache = attn.self_attention_decode(cfg, p["attn"], h, cache, pos,
                                              window=self._window(cfg), impl=impl)
        return self._mlp(cfg, p, x + y), cache

    @classmethod
    def decode_paged(cls, cfg, p, x, cache, block_tables, context_lens, kv_spec=None,
                     block_pages=None):
        h = apply_norm(cfg, x, p["ln_attn"])
        y, _ = attn.self_attention_decode_paged(
            cfg, p["attn"], h, cache, block_tables, context_lens, kv_spec=kv_spec,
            block_pages=block_pages,
        )
        return cls._mlp(cfg, p, x + y)

    @classmethod
    def prefill_chunk_paged(cls, cfg, p, x, cache, block_tables, write_tables,
                            cursors, n_new, kv_spec=None):
        h = apply_norm(cfg, x, p["ln_attn"])
        y, _ = attn.self_attention_prefill_chunk_paged(
            cfg, p["attn"], h, cache, block_tables, write_tables, cursors, n_new,
            kv_spec=kv_spec,
        )
        return cls._mlp(cfg, p, x + y)

    @classmethod
    def verify_paged(cls, cfg, p, x, cache, block_tables, context_lens, kv_spec=None):
        h = apply_norm(cfg, x, p["ln_attn"])
        y, _ = attn.self_attention_verify_paged(
            cfg, p["attn"], h, cache, block_tables, context_lens, kv_spec=kv_spec,
        )
        return cls._mlp(cfg, p, x + y)


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

    @staticmethod
    def _mlp_aux(cfg, p, x):
        y, aux = moe_mod.apply_moe(cfg, p["moe"], apply_norm(cfg, x, p["ln_moe"]))
        return x + y, aux

    @classmethod
    def _mlp(cls, cfg, p, x):
        return cls._mlp_aux(cfg, p, x)[0]


class SSMBlock:
    """Pre-norm Mamba-2 mixer (no MLP); decode updates one layer's state and
    conv rows in place."""

    @staticmethod
    def specs(cfg, quant=None):
        return {"ln": norm_specs(cfg), "ssm": ssm_mod.ssm_specs(cfg, quant=quant)}

    @staticmethod
    def cache_specs(cfg, batch: int, seq: int):
        return ssm_mod.ssm_cache_specs(cfg, batch)

    @staticmethod
    def train(cfg, p, x, impl="auto", ctx=None):
        return x + ssm_mod.apply_ssm(cfg, p["ssm"], apply_norm(cfg, x, p["ln"]), impl=impl), 0.0

    @staticmethod
    def prefill(cfg, p, x, max_len=None, impl="auto", ctx=None):
        h = apply_norm(cfg, x, p["ln"])
        y, cache = ssm_mod.apply_ssm(cfg, p["ssm"], h, return_state=True, impl=impl)
        return x + y, cache

    @staticmethod
    def decode(cfg, p, x, cache, pos, impl="auto"):
        y, new = ssm_mod.apply_ssm_decode(cfg, p["ssm"], apply_norm(cfg, x, p["ln"]), cache, pos)
        for name, t in new.items():
            cache[name].copy_(t)
        return x + y, cache


class RecBlock:
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

    @staticmethod
    def train(cfg, p, x, impl="auto", ctx=None):
        x = x + rg_mod.apply_rglru(cfg, p["rec"], apply_norm(cfg, x, p["ln_rec"]), impl=impl)
        return DenseBlock._mlp(cfg, p, x), 0.0

    @staticmethod
    def prefill(cfg, p, x, max_len=None, impl="auto", ctx=None):
        h = apply_norm(cfg, x, p["ln_rec"])
        y, cache = rg_mod.apply_rglru(cfg, p["rec"], h, return_state=True, impl=impl)
        return DenseBlock._mlp(cfg, p, x + y), cache

    @staticmethod
    def decode(cfg, p, x, cache, pos, impl="auto"):
        h = apply_norm(cfg, x, p["ln_rec"])
        y, cache = rg_mod.apply_rglru_decode(cfg, p["rec"], h, cache, pos)
        return DenseBlock._mlp(cfg, p, x + y), cache


class RGGroup:
    """RecurrentGemma's repeating unit: [rec, rec, local_attn], with nested
    {"rec0", "rec1", "attn"} parameters and caches."""

    PARTS = (("rec0", RecBlock()), ("rec1", RecBlock()), ("attn", DenseBlock(use_window=True)))

    def specs(self, cfg, quant=None):
        return {name: blk.specs(cfg, quant) for name, blk in self.PARTS}

    def cache_specs(self, cfg, batch: int, seq: int):
        return {name: blk.cache_specs(cfg, batch, seq) for name, blk in self.PARTS}

    def train(self, cfg, p, x, impl="auto", ctx=None):
        for name, blk in self.PARTS:
            x, _ = blk.train(cfg, p[name], x, impl=impl)
        return x, 0.0

    def prefill(self, cfg, p, x, max_len=None, impl="auto", ctx=None):
        caches = {}
        for name, blk in self.PARTS:
            x, caches[name] = blk.prefill(cfg, p[name], x, max_len=max_len, impl=impl)
        return x, caches

    def decode(self, cfg, p, x, cache, pos, impl="auto"):
        for name, blk in self.PARTS:
            x, _ = blk.decode(cfg, p[name], x, cache[name], pos, impl=impl)
        return x, cache


def _cross_cache(cfg, k, v):
    """A cross-attention layer's cache: the context's K/V in the param dtype."""
    return {"k": k.to(cfg.param_dtype), "v": v.to(cfg.param_dtype)}


class DecBlock:
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

    @staticmethod
    def train(cfg, p, x, impl="auto", ctx=None):
        x = x + attn.self_attention(cfg, p["self"], apply_norm(cfg, x, p["ln_self"]), impl=impl)
        h = apply_norm(cfg, x, p["ln_cross"])
        x = x + attn.cross_attention(cfg, p["cross"], h, ctx, impl=impl)
        return DenseBlock._mlp(cfg, p, x), 0.0

    @staticmethod
    def prefill(cfg, p, x, max_len=None, impl="auto", ctx=None):
        h = apply_norm(cfg, x, p["ln_self"])
        y, (k, v) = attn.self_attention(cfg, p["self"], h, return_kv=True, impl=impl)
        x = x + y
        h = apply_norm(cfg, x, p["ln_cross"])
        y, (ck, cv) = attn.cross_attention(cfg, p["cross"], h, ctx, return_kv=True, impl=impl)
        return DenseBlock._mlp(cfg, p, x + y), {
            "self": attn.pack_kv_cache(cfg, k, v, max_len=max_len),
            "cross": _cross_cache(cfg, ck, cv)}

    @staticmethod
    def decode(cfg, p, x, cache, pos, impl="auto"):
        h = apply_norm(cfg, x, p["ln_self"])
        y, _ = attn.self_attention_decode(cfg, p["self"], h, cache["self"], pos, impl=impl)
        x = x + y
        h = apply_norm(cfg, x, p["ln_cross"])
        kv = (cache["cross"]["k"], cache["cross"]["v"])
        x = x + attn.cross_attention_decode(cfg, p["cross"], h, kv, impl=impl)
        return DenseBlock._mlp(cfg, p, x), cache


def _stack_specs(specs, n: int):
    """A (nested) dict of ParamSpecs with a leading dim ``n`` on each."""
    if isinstance(specs, dict):
        return {k: _stack_specs(v, n) for k, v in specs.items()}
    return dataclasses.replace(specs, shape=(n,) + specs.shape)


class VisGroup:
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
            "gate": ParamSpec((), torch.float32, "zeros"),
            "ln_mlp": norm_specs(cfg),
            "mlp": mlp_specs(cfg, quant=quant),
        }

    def cache_specs(self, cfg, batch: int, seq: int):
        return {"self": _stack_specs(self.DENSE.cache_specs(cfg, batch, seq), self.N_SELF),
                "cross": attn.cache_specs(cfg, batch, cfg.n_img_tokens)}

    @staticmethod
    def _gated(cfg, p, x, y):
        return DenseBlock._mlp(cfg, p, x + torch.tanh(p["gate"]).to(x.dtype) * y)

    def train(self, cfg, p, x, impl="auto", ctx=None):
        for pl in p["self"]:
            x, _ = self.DENSE.train(cfg, pl, x, impl=impl)
        h = apply_norm(cfg, x, p["ln_cross"])
        return self._gated(cfg, p, x, attn.cross_attention(cfg, p["cross"], h, ctx, impl=impl)), 0.0

    def prefill(self, cfg, p, x, max_len=None, impl="auto", ctx=None):
        caches = []
        for pl in p["self"]:
            x, c = self.DENSE.prefill(cfg, pl, x, max_len=max_len, impl=impl)
            caches.append(c)
        h = apply_norm(cfg, x, p["ln_cross"])
        y, (ck, cv) = attn.cross_attention(cfg, p["cross"], h, ctx, return_kv=True, impl=impl)
        return self._gated(cfg, p, x, y), {"self": _stack(caches),
                                          "cross": _cross_cache(cfg, ck, cv)}

    def decode(self, cfg, p, x, cache, pos, impl="auto"):
        for i, pl in enumerate(p["self"]):
            x, _ = self.DENSE.decode(cfg, pl, x, _layer(cache["self"], i), pos, impl=impl)
        h = apply_norm(cfg, x, p["ln_cross"])
        kv = (cache["cross"]["k"], cache["cross"]["v"])
        return self._gated(cfg, p, x, attn.cross_attention_decode(cfg, p["cross"], h, kv,
                                                                  impl=impl)), cache


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
    def encode_ctx(self, params, batch: Dict[str, torch.Tensor], *, attn_impl: str = "auto"):
        """The cross-attention context: for whisper the encoder over
        ``batch["frames"]`` (B, enc_seq, D) precomputed frame embeddings, plus
        the f32 sinusoidal table cast to their dtype, through n_enc_layers
        non-causal layers (RoPE at positions 0..T-1 on top, as the
        reference's self-attention applies it) and the final norm; for vlm
        ``batch["image_embeds"]`` as given; None otherwise."""
        cfg = self.cfg
        if cfg.family == "encdec":
            frames = batch["frames"]
            x = frames + _sinusoidal(frames.shape[1], cfg.d_model,
                                     frames.device).to(frames.dtype)[None]
            enc_cfg = dataclasses.replace(cfg, mlp_act="gelu")
            for p in params["encoder"]["blocks"][0]:
                x, _ = KINDS["enc"].train(enc_cfg, p, x, impl=attn_impl)
            return apply_norm(cfg, x, params["encoder"]["final_norm"])
        if cfg.family == "vlm":
            return batch["image_embeds"]
        return None

    # ---- full-sequence forward -------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, *, ctx=None, attn_impl: str = "auto",
                remat: bool = False, remat_policy: Optional[str] = None):
        """tokens (B, T) -> (logits (B, T, Vp), aux): aux the f32 sum of the MoE
        layers' aux losses in layer order (0 for the other blocks). ``ctx``:
        the cross-attention context (``encode_ctx``) for encdec / vlm.

        ``remat`` recomputes each layer in the backward instead of keeping its
        activations (the reference's per-layer ``jax.checkpoint``:
        ``torch.utils.checkpoint`` without reentry); ``remat_policy`` "dots"
        keeps the outputs of the layer's matmuls (``aten.mm`` / ``aten.bmm``)
        and recomputes the rest, None or "nothing" keeps nothing. Without
        grad mode it changes nothing."""
        x = self._embed(params, tokens)
        aux = torch.zeros((), device=x.device)
        run = _remat(remat, remat_policy)
        for blk, layers in self._program(params):
            for p in layers:
                x, a = run(blk.train, self.cfg, p, x, impl=attn_impl, ctx=ctx)
                aux = aux + a
        return self._head(params, x), aux

    def loss_fn(self, params, batch: Dict[str, torch.Tensor], *, remat: bool = True,
                remat_policy: Optional[str] = None, aux_weight: float = 0.01,
                attn_impl: str = "auto"):
        """The training loss, as the reference's: next-token CE of
        ``forward(tokens[:, :-1])`` against ``tokens[:, 1:]`` (``batch["mask"]``
        weighting positions when given), the context encoded first for encdec
        / vlm (``batch["frames"]`` / ``batch["image_embeds"]``), plus
        ``aux_weight`` times the MoE aux loss. -> (loss, {"ce", "aux"}).

        On the card the ssm and hybrid families raise NotImplementedError:
        ssd_scan and rglru_scan have no backward on CUDA yet (ROADMAP item 5),
        and their plain versions are not a training path there. On the CPU
        every family trains through the plain versions, as the reference
        trains through its jnp twins."""
        tokens = batch["tokens"]
        if tokens.device.type == "cuda" and self.cfg.family in ("ssm", "hybrid"):
            raise NotImplementedError(
                f"training the {self.cfg.family} family on CUDA needs a backward for "
                "ssd_scan / rglru_scan, which the port does not have yet (ROADMAP item 5)"
            )
        inp, labels = tokens[:, :-1], tokens[:, 1:]
        ctx = self.encode_ctx(params, batch, attn_impl=attn_impl)
        logits, aux = self.forward(params, inp, ctx=ctx, attn_impl=attn_impl, remat=remat,
                                   remat_policy=remat_policy)
        loss = cross_entropy(logits, labels, batch.get("mask"))
        return loss + aux_weight * aux, {"ce": loss, "aux": aux}

    # ---- serving ---------------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor, *, ctx=None, batch_inputs=None,
                max_len: Optional[int] = None, last_index=None, attn_impl: str = "auto"):
        """tokens (B, S) -> (logits (B, 1, Vp), caches). The logits are read at
        ``last_index`` (default: the last column) — the engine right-pads
        prompts to whole pages; leave it None for the SSM family, whose final
        state padding would pollute. caches: one dict per program entry,
        {"k", "v": (L, B, Hkv, max_len, Dh)} (dense) or {"state", "conv"} (ssm),
        {"self", "cross"} (dec, vis_group). ``ctx`` is the cross-attention
        context; without it, ``batch_inputs`` ({"frames"} or
        {"image_embeds"}) goes through ``encode_ctx`` first."""
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
                    attn_impl: str = "auto"):
        """One token per row against the dense-cache state prefill returned:
        tokens (B,) at position ``pos`` (an int or a one-element integer
        tensor on the model's device, the same for every row). The caches are
        updated in place and returned. An int ``pos`` at or past the capacity of
        a dense cache without a window raises ValueError. -> (logits (B, Vp),
        caches)."""
        if not isinstance(pos, torch.Tensor):
            pos = attn.DecodePos(int(pos), torch.full((1,), int(pos), dtype=torch.int32,
                                                      device=self.device))
        x = self._embed(params, tokens[:, None])
        for (blk, layers), cache in zip(self._program(params), caches):
            for l, p in enumerate(layers):
                x, _ = blk.decode(self.cfg, p, x, _layer(cache, l), pos, impl=attn_impl)
        return self._head(params, x)[:, 0], caches

    def decode_step_paged(self, params, caches, tokens: torch.Tensor,
                          block_tables: torch.Tensor, context_lens: torch.Tensor, *,
                          kv_spec=None, write_tables=None, n_new=None,
                          last_index=None, active=None, spec_verify: bool = False,
                          block_pages=None):
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

        Returns (logits (B, Vp), caches)."""
        self._paged_only_dense()
        cfg = self.cfg
        chunk = tokens.dim() == 2 and not spec_verify
        if active is not None and not chunk:
            on = active > 0
            block_tables = torch.where(on[:, None], block_tables, torch.zeros_like(block_tables))
            context_lens = torch.where(on, context_lens, torch.zeros_like(context_lens))
        x = self._embed(params, tokens if tokens.dim() == 2 else tokens[:, None])
        pool = caches[0]
        blk = KINDS[block_program(cfg)[0][0]]
        for l, p in enumerate(params["blocks"][0]):
            cache = _layer(pool, l)
            if spec_verify:
                x = blk.verify_paged(cfg, p, x, cache, block_tables, context_lens,
                                     kv_spec=kv_spec)
            elif chunk:
                x = blk.prefill_chunk_paged(
                    cfg, p, x, cache, block_tables, write_tables, context_lens, n_new,
                    kv_spec=kv_spec,
                )
            else:
                x = blk.decode_paged(
                    cfg, p, x, cache, block_tables, context_lens, kv_spec=kv_spec,
                    block_pages=block_pages,
                )
        if spec_verify:
            # row j of the window decides draft j + 1 (the last row the bonus)
            return self._head(params, x), caches
        if chunk:
            # only each row's requested position pays the vocab matmul
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, last_index.long()][:, None]
        return self._head(params, x)[:, 0], caches

