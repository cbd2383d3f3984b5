"""The dense decoder stack of the port: DenseBlock and Model.

Port of the dense half of ``repro.models.transformer``. Parameters are plain
nested dicts of tensors with the reference's leaf names and weight layouts;
where the reference stacks a leading layer dim and scans, the port keeps one
dict per layer (``params["blocks"][0][l]``) and loops. Page pools keep the
stacked form, (L, num_pages, Hkv, ps, Dh) (or its {"q", "scale"} quantized
form, each leaf with the leading layer dim), and per-layer views of them are
updated in place. ``Model(cfg, quant=...)`` stores the MLP weights through a
QuantizedAccessor (int8 serving weights).
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch

from repro_torch.kernels.common import resolve_device

from . import attention as attn
from .layers import (
    apply_embed,
    apply_lm_head,
    apply_mlp,
    apply_norm,
    embed_specs,
    init_tree,
    mlp_specs,
    rmsnorm_spec,
)


class DenseBlock:
    """Pre-norm self-attention + SwiGLU MLP; the paged paths write one layer's
    page pool in place."""

    @staticmethod
    def specs(cfg, quant=None):
        return {
            "ln_attn": rmsnorm_spec(cfg.d_model),
            "attn": attn.attn_specs(cfg),
            "ln_mlp": rmsnorm_spec(cfg.d_model),
            "mlp": mlp_specs(cfg, quant=quant),
        }

    @staticmethod
    def _mlp(cfg, p, x):
        return x + apply_mlp(cfg, p["mlp"], apply_norm(cfg, x, p["ln_mlp"]))

    @classmethod
    def train(cls, cfg, p, x):
        h = apply_norm(cfg, x, p["ln_attn"])
        x = x + attn.self_attention(cfg, p["attn"], h)
        return cls._mlp(cfg, p, x)

    @classmethod
    def prefill(cls, cfg, p, x, max_len=None):
        h = apply_norm(cfg, x, p["ln_attn"])
        y, (k, v) = attn.self_attention(cfg, p["attn"], h, return_kv=True)
        x = cls._mlp(cfg, p, x + y)
        return x, attn.pack_kv_cache(cfg, k, v, max_len=max_len)

    @classmethod
    def decode_paged(cls, cfg, p, x, cache, block_tables, context_lens, kv_spec=None):
        h = apply_norm(cfg, x, p["ln_attn"])
        y, _ = attn.self_attention_decode_paged(
            cfg, p["attn"], h, cache, block_tables, context_lens, kv_spec=kv_spec,
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


def _layer(tree, l: int):
    """Layer ``l``'s view of a stacked pool dict (nested for quantized pools)."""
    if isinstance(tree, dict):
        return {k: _layer(v, l) for k, v in tree.items()}
    return tree[l]


class Model:
    """A dense decoder on one device. ``device`` defaults to CUDA and raises
    without a GPU; pass ``device="cpu"`` to run the plain versions. ``quant``
    (core.QuantizedAccessor) stores the MLP weights quantized, as the
    reference's serving-weight accessor."""

    def __init__(self, cfg, quant=None, device=None):
        if cfg.family != "dense":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP Queue 1: other families)"
            )
        if cfg.window is not None:
            raise NotImplementedError("local attention windows are not ported yet")
        self.cfg = cfg
        self.quant = quant
        self.device = resolve_device(device)

    # ---- specs / init --------------------------------------------------------------
    def param_specs(self):
        cfg = self.cfg
        return {
            "embed": embed_specs(cfg),
            "blocks": [[DenseBlock.specs(cfg, self.quant) for _ in range(cfg.n_layers)]],
            "final_norm": rmsnorm_spec(cfg.d_model),
        }

    def init_params(self, generator: torch.Generator, device=None):
        """Random parameters from ``generator`` (which must live on the target
        device) with the reference's init scheme."""
        return init_tree(self.param_specs(), generator, device or self.device)

    def paged_cache_specs(self, num_pages: int, page_size: int, kv_spec=None):
        return [attn.paged_cache_specs(self.cfg, num_pages, page_size, kv_spec=kv_spec)]

    def init_paged_cache(self, num_pages: int, page_size: int, kv_spec=None) -> List[Dict]:
        """Zeroed page pools, one {"k", "v"} dict per block-program entry with a
        leading layer dim: (L, num_pages, Hkv, ps, Dh), or with ``kv_spec``
        {"q": (L, num_pages, Hkv, ps, Dq) int8, "scale": (L, num_pages, Hkv)}
        for each of k and v."""
        def zeros(spec):
            if isinstance(spec, dict):
                return {k: zeros(v) for k, v in spec.items()}
            return torch.zeros((self.cfg.n_layers,) + spec.shape, dtype=spec.dtype,
                               device=self.device)

        return [zeros(entry) for entry in self.paged_cache_specs(num_pages, page_size, kv_spec)]

    def _embed(self, params, tokens: torch.Tensor) -> torch.Tensor:
        return apply_embed(params["embed"], tokens)

    def _head(self, params, x: torch.Tensor) -> torch.Tensor:
        x = apply_norm(self.cfg, x, params["final_norm"])
        return apply_lm_head(self.cfg, params["embed"], x)

    # ---- full-sequence forward -------------------------------------------------------
    def forward(self, params, tokens: torch.Tensor):
        """tokens (B, T) -> (logits (B, T, Vp), aux); aux is 0 for dense blocks."""
        x = self._embed(params, tokens)
        for p in params["blocks"][0]:
            x = DenseBlock.train(self.cfg, p, x)
        return self._head(params, x), torch.zeros((), device=x.device)

    # ---- serving ---------------------------------------------------------------------
    def prefill(self, params, tokens: torch.Tensor, *, max_len: Optional[int] = None,
                last_index=None):
        """tokens (B, S) -> (logits (B, 1, Vp), caches). The logits are read at
        ``last_index`` (default: the last column) — the engine right-pads
        prompts to whole pages. caches: [{"k", "v": (L, B, Hkv, max_len, Dh)}]."""
        x = self._embed(params, tokens)
        ks, vs = [], []
        for p in params["blocks"][0]:
            x, c = DenseBlock.prefill(self.cfg, p, x, max_len=max_len)
            ks.append(c["k"])
            vs.append(c["v"])
        if last_index is None:
            x_last = x[:, -1:]
        else:
            i = int(last_index)
            x_last = x[:, i:i + 1]
        logits = self._head(params, x_last)
        return logits, [{"k": torch.stack(ks), "v": torch.stack(vs)}]

    def decode_step_paged(self, params, caches, tokens: torch.Tensor,
                          block_tables: torch.Tensor, context_lens: torch.Tensor, *,
                          kv_spec=None, write_tables=None, n_new=None,
                          last_index=None, active=None):
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

        Returns (logits (B, Vp), caches)."""
        cfg = self.cfg
        chunk = tokens.dim() == 2
        if active is not None and not chunk:
            on = active > 0
            block_tables = torch.where(on[:, None], block_tables, torch.zeros_like(block_tables))
            context_lens = torch.where(on, context_lens, torch.zeros_like(context_lens))
        x = self._embed(params, tokens if chunk else tokens[:, None])
        pool = caches[0]
        for l, p in enumerate(params["blocks"][0]):
            cache = _layer(pool, l)
            if chunk:
                x = DenseBlock.prefill_chunk_paged(
                    cfg, p, x, cache, block_tables, write_tables, context_lens, n_new,
                    kv_spec=kv_spec,
                )
            else:
                x = DenseBlock.decode_paged(
                    cfg, p, x, cache, block_tables, context_lens, kv_spec=kv_spec,
                )
        if chunk:
            # only each row's requested position pays the vocab matmul
            rows = torch.arange(x.shape[0], device=x.device)
            x = x[rows, last_index.long()][:, None]
        return self._head(params, x)[:, 0], caches

