"""The decoder stack of the port: the dense, MoE, SSM and hybrid block kinds
and Model.

Port of the dense, MoE, Mamba-2 and recurrentgemma part of
``repro.models.transformer``. An architecture is a program of (block kind,
count) entries (``block_program``).
Parameters are plain nested dicts of tensors with the reference's leaf names
and weight layouts; where the reference stacks a leading layer dim and scans,
the port keeps one dict per layer (``params["blocks"][i][l]`` for program
entry i) and loops. Caches keep the stacked form: the dense decode cache
{"k", "v": (L, B, Hkv, S, Dh)} (S the window for a local-attention ring),
the SSM cache {"state": (L, B, H, P, N), "conv": (L, B, K - 1, conv_dim)},
the RG-LRU cache {"h": (L, B, W), "conv": (L, B, K - 1, W)}, a group's
nested {"rec0", "rec1", "attn"} of those, the page pools (L, num_pages, Hkv,
ps, Dh) (or their {"q", "scale"} quantized form); per-layer views of them are
updated in place. ``Model(cfg, quant=...)`` stores the MLP (and expert) weights
through a QuantizedAccessor (int8 serving weights).

``attn_impl`` on forward / prefill / decode_step picks the kernels of the
dense-cache path (flash_attention, flash_decode, ssd_scan, rglru_scan:
"auto" | "cuda" | "torch", as kernels.ops), so an oracle can force the plain
versions.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.kernels.common import resolve_device

from . import attention as attn
from . import moe as moe_mod
from . import rglru as rg_mod
from . import ssm as ssm_mod
from .layers import (
    apply_embed,
    apply_lm_head,
    apply_mlp,
    apply_norm,
    embed_specs,
    init_tree,
    mlp_specs,
    norm_specs,
)


class DenseBlock:
    """Pre-norm self-attention (+ a local window for ``use_window``, the
    hybrid family's local_attn kind) + gated MLP; decode and the paged paths
    write one layer's cache or page pool in place."""

    def __init__(self, use_window: bool = False):
        self.use_window = use_window

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

    def train(self, cfg, p, x, impl="auto"):
        """-> (x, aux): aux the layer's router loss (0 without experts)."""
        h = apply_norm(cfg, x, p["ln_attn"])
        x = x + attn.self_attention(cfg, p["attn"], h, window=self._window(cfg), impl=impl)
        return self._mlp_aux(cfg, p, x)

    def prefill(self, cfg, p, x, max_len=None, impl="auto"):
        h = apply_norm(cfg, x, p["ln_attn"])
        w = self._window(cfg)
        y, (k, v) = attn.self_attention(cfg, p["attn"], h, window=w, return_kv=True, impl=impl)
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
    def train(cfg, p, x, impl="auto"):
        return x + ssm_mod.apply_ssm(cfg, p["ssm"], apply_norm(cfg, x, p["ln"]), impl=impl), 0.0

    @staticmethod
    def prefill(cfg, p, x, max_len=None, impl="auto"):
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
    def train(cfg, p, x, impl="auto"):
        x = x + rg_mod.apply_rglru(cfg, p["rec"], apply_norm(cfg, x, p["ln_rec"]), impl=impl)
        return DenseBlock._mlp(cfg, p, x), 0.0

    @staticmethod
    def prefill(cfg, p, x, max_len=None, impl="auto"):
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

    def train(self, cfg, p, x, impl="auto"):
        for name, blk in self.PARTS:
            x, _ = blk.train(cfg, p[name], x, impl=impl)
        return x, 0.0

    def prefill(self, cfg, p, x, max_len=None, impl="auto"):
        caches = {}
        for name, blk in self.PARTS:
            x, caches[name] = blk.prefill(cfg, p[name], x, max_len=max_len, impl=impl)
        return x, caches

    def decode(self, cfg, p, x, cache, pos, impl="auto"):
        for name, blk in self.PARTS:
            x, _ = blk.decode(cfg, p[name], x, cache[name], pos, impl=impl)
        return x, cache


KINDS = {
    "dense": DenseBlock(),
    "moe": MoEBlock(),
    "local_attn": DenseBlock(use_window=True),
    "ssm": SSMBlock(),
    "rec": RecBlock(),
    "rg_group": RGGroup(),
}


def block_program(cfg):
    """The architecture as (block kind, count) entries, as in the reference
    (only the ported families resolve). The hybrid family is n_layers //
    len(pattern) groups (kept when that is 0, as the reference keeps it) and
    the remainder as rec blocks."""
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
    raise NotImplementedError(
        f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1 item 4: the "
        f"encoder-decoder and vision families)"
    )


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
    """A dense (GQA), MoE, SSM (Mamba-2) or hybrid (recurrentgemma) decoder on
    one device. ``device`` defaults to CUDA and raises without a GPU; pass
    ``device="cpu"`` to run the plain versions. ``quant`` (core.QuantizedAccessor) stores the MLP
    weights quantized, as the reference's serving-weight accessor."""

    def __init__(self, cfg, quant=None, device=None):
        block_program(cfg)  # refuses the families that are not ported
        self.cfg = cfg
        self.quant = quant
        self.device = resolve_device(device)

    def _program(self, params):
        """(block class, its per-layer params) for each program entry."""
        return [(KINDS[kind], p) for (kind, _), p in zip(block_program(self.cfg),
                                                         params["blocks"])]

    # ---- specs / init --------------------------------------------------------------
    def param_specs(self):
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "blocks": [[KINDS[kind].specs(cfg, self.quant) for _ in range(n)]
                       for kind, n in block_program(cfg)],
            "final_norm": norm_specs(cfg),
        }

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

    # ---- full-sequence forward -------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor, *, attn_impl: str = "auto"):
        """tokens (B, T) -> (logits (B, T, Vp), aux): aux the f32 sum of the MoE
        layers' aux losses in layer order (0 for the other blocks)."""
        x = self._embed(params, tokens)
        aux = torch.zeros((), device=x.device)
        for blk, layers in self._program(params):
            for p in layers:
                x, a = blk.train(self.cfg, p, x, impl=attn_impl)
                aux = aux + a
        return self._head(params, x), aux

    # ---- serving ---------------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor, *, max_len: Optional[int] = None,
                last_index=None, attn_impl: str = "auto"):
        """tokens (B, S) -> (logits (B, 1, Vp), caches). The logits are read at
        ``last_index`` (default: the last column) — the engine right-pads
        prompts to whole pages; leave it None for the SSM family, whose final
        state padding would pollute. caches: one dict per program entry,
        {"k", "v": (L, B, Hkv, max_len, Dh)} (dense) or {"state", "conv"} (ssm)."""
        x = self._embed(params, tokens)
        caches = []
        for blk, layers in self._program(params):
            per_layer = []
            for p in layers:
                x, c = blk.prefill(self.cfg, p, x, max_len=max_len, impl=attn_impl)
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

