"""Serve-step factories of the port: the dense-cache decode step, the fused
paged decode step, the chunked prefill step and monolithic prefill. Plain
Python functions over the model — PyTorch runs eagerly, so there is nothing
to compile.

The fused decode step keeps the decode hot path on the device: it appends,
attends, samples (``kernels.ops.sample_tokens``) and advances the lengths
(``context_lens + active``) without the logits ever leaving the device; the
engine fetches only the sampled ids and their log-probabilities.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops


def make_serve_step(model, attn_impl: str = "auto"):
    """The dense-cache decode step (``Model.decode_step``): one token per row
    against the caches ``make_prefill(model, max_len)`` returned."""

    def serve_step(params, caches, tokens, pos):
        """tokens (B,) int; pos an int or a one-element int tensor -> (logits
        (B, Vp), caches updated in place)."""
        return model.decode_step(params, caches, tokens, pos, attn_impl=attn_impl)

    return serve_step


def make_paged_serve_step(model, kv_spec=None):
    """The fused decode step over the engine's pools (``kv_spec``: their
    quantized element representation, None for dense pages)."""
    vocab = model.cfg.vocab

    def fused_serve_step(params, caches, tokens, block_tables, context_lens, slot_f32,
                         slot_i32, sampled: Optional[bool] = None):
        """One batched decode token per active slot, sampled on the device.

        slot_f32 (2, B): [temperature, top_p]; slot_i32 (3, B): [active, top_k,
        seed bits]. ``active`` is the phase bitmap (inactive rows write the
        null page); the sampled position is ``context_lens + 1``, the length of
        the context the new token extends. ``sampled`` is the host's knowledge
        of whether any slot has temperature > 0. Returns (next_tokens (B,)
        int32, logits (B, Vp), new_lens (B,), caches, chosen_lp (B,) f32)."""
        active = slot_i32[0]
        logits, caches = model.decode_step_paged(
            params, caches, tokens, block_tables, context_lens, kv_spec=kv_spec, active=active,
        )
        nxt = ops.sample_tokens(
            logits, slot_f32[0], slot_i32[1], slot_f32[1], slot_i32[2], context_lens + 1,
            vocab=vocab, sampled=sampled,
        )
        new_lens = context_lens + (active > 0).to(context_lens.dtype)
        lp = torch.log_softmax(logits[:, :vocab].float(), dim=-1)
        chosen_lp = lp.gather(1, nxt[:, None].long())[:, 0]
        return nxt, logits, new_lens, caches, chosen_lp

    return fused_serve_step


def make_chunked_prefill_step(model, kv_spec=None):
    def chunk_prefill_step(params, caches, tokens, block_tables, write_tables, cursors,
                           n_new, last_index):
        """One prefill chunk per row: tokens (B, C) -> (logits (B, Vp) at
        last_index, caches updated in place). ``block_tables`` is the read view
        (shared prefix included), ``write_tables`` the write view."""
        return model.decode_step_paged(
            params, caches, tokens, block_tables, cursors, kv_spec=kv_spec,
            write_tables=write_tables, n_new=n_new, last_index=last_index,
        )

    return chunk_prefill_step


def make_prefill(model, max_len: Optional[int] = None, attn_impl: str = "auto"):
    """Monolithic prefill; with ``max_len`` the dense caches are padded to it
    (the capacity ``make_serve_step`` decodes into)."""

    def prefill(params, tokens, last_index=None):
        return model.prefill(params, tokens, max_len=max_len, last_index=last_index,
                             attn_impl=attn_impl)

    return prefill
