"""Serve-step factories of the port: the dense-cache decode step, the fused
paged decode step, the chunked prefill step and monolithic prefill. Plain
Python functions over the model — PyTorch runs eagerly, so there is nothing
to compile.

The fused decode step keeps the decode hot path on the device: it appends,
attends, samples (``kernels.ops.sample_tokens``) and advances the lengths
(``context_lens + active``) without the logits ever leaving the device; the
engine fetches only the sampled ids and their log-probabilities (and, with
``logprobs_k``, the top-k log-probability pair). ``make_paged_serve_multistep``
runs K such steps in one host loop with no device-to-host transfer inside it:
each sampled token feeds the next step's embedding on the device, and the K
steps' outputs stack there for one fetch. The speculative sibling is
``serving.speculative.make_paged_serve_spec_multistep``.

With ``grammar=True`` the fused steps carry the constrained-decoding stage:
each slot's additive mask row is gathered by its automaton state
(``gmask[gstate]``) and the state advances by the token just sampled
(``gtrans[gstate, tok]``), both on the device, so the K-step loop keeps its
one transfer a dispatch.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops
from repro_torch.models.layers import Sharder


def make_serve_step(model, mesh=None, rules=None, attn_impl: str = "auto"):
    """The dense-cache decode step (``Model.decode_step``): one token per row
    against the caches ``make_prefill(model, max_len)`` returned. With
    ``mesh`` and ``rules`` (``launch.serve_rules``) the step runs on the
    mesh (``Sharder(mesh, rules)``): params the DTensor tree
    ``serving.distribute_params`` gives, the caches the DTensors the sharded
    prefill returned, tokens whole on every rank; the logits come back
    whole on every rank."""
    shard = Sharder(mesh, rules)

    def serve_step(params, caches, tokens, pos):
        """tokens (B,) int; pos an int or a one-element int tensor -> (logits
        (B, Vp), caches updated in place)."""
        return model.decode_step(params, caches, tokens, pos, attn_impl=attn_impl, shard=shard)

    return serve_step


def distribute_params(model, params, mesh, rules):
    """A parameter tree every rank built alike (the same seed, or the same
    checkpoint) laid onto ``mesh`` by ``rules`` on the model's specs: each
    rank keeps its block (``core.distributed.tree_distribute``)."""
    from repro_torch.core.distributed import tree_distribute

    return tree_distribute(params, model.param_specs(), mesh, rules)


def top_logprobs(logits: torch.Tensor, vocab: int, k: int):
    """(vals (B, k) f32, ids (B, k) int32): the top-k log-probabilities of
    each row's next-token distribution (pad columns excluded), computed on
    the device from the logits the sampler reads, ordered by (-value, id) as
    ``jax.lax.top_k`` orders ties (``ops.top_k_lower_id_first``)."""
    vals, top = ops.top_k_lower_id_first(torch.log_softmax(logits[:, :vocab].float(), dim=-1), k)
    return vals, top.to(torch.int32)


def _fused_decode(model, kv_spec, vocab, params, caches, tokens, block_tables,
                  context_lens, slot_f32, slot_i32, sampled, grammar=None, block_pages=None,
                  shard=Sharder()):
    """One fused decode iteration: append -> attend -> sample, on the device.

    slot_f32 (2, B): [temperature, top_p]; slot_i32 (3, B): [active, top_k,
    seed bits]. ``active`` is the phase bitmap (inactive rows write the null
    page); the sampled position is ``context_lens + 1``, the length of the
    context the new token extends, so K fused steps sample what K single
    steps would. ``grammar`` (None or (gstate (B,) int32, gmask (S, vocab)
    f32, gtrans (S, vocab) int32)): each slot's mask row is added to its
    logits in the sampler and its state advances by the sampled token; row 0
    of the tables is the unconstrained state (zero mask, self-loops).
    ``block_pages`` is the tuned decode block-shape knob, forwarded to the
    paged decode (None = unblocked).

    Returns (next_tokens (B,) int32, logits (B, Vp), new_lens (B,), caches,
    chosen_lp (B,) f32[, new_gstate (B,) int32 with grammar]): chosen_lp is
    log P(next_token | prefix) under the UNMASKED distribution (a grammar
    constrains the selection, not the score)."""
    active = slot_i32[0]
    logits, caches = model.decode_step_paged(
        params, caches, tokens, block_tables, context_lens, kv_spec=kv_spec, active=active,
        block_pages=block_pages, shard=shard,
    )
    mask = None
    if grammar is not None:
        gstate, gmask, gtrans = grammar
        mask = gmask[gstate.long()]  # (B, vocab) per-slot additive rows
    nxt = ops.sample_tokens(
        logits, slot_f32[0], slot_i32[1], slot_f32[1], slot_i32[2], context_lens + 1,
        vocab=vocab, sampled=sampled, mask=mask,
    )
    new_lens = context_lens + (active > 0).to(context_lens.dtype)
    lp = torch.log_softmax(logits[:, :vocab].float(), dim=-1)
    chosen_lp = lp.gather(1, nxt[:, None].long())[:, 0]
    if grammar is None:
        return nxt, logits, new_lens, caches, chosen_lp
    new_gstate = torch.where(active > 0, gtrans[gstate.long(), nxt.long()], gstate)
    return nxt, logits, new_lens, caches, chosen_lp, new_gstate


def make_paged_serve_step(model, kv_spec=None, logprobs_k: int = 0, grammar: bool = False,
                          block_pages: Optional[int] = None, mesh=None, rules=None):
    """The fused decode step over the engine's pools (``kv_spec``: their
    quantized element representation, None for dense pages). With ``mesh``
    and ``rules`` it runs on the mesh (``Model.decode_step_paged(shard=)``):
    the logits whole on every rank, so every rank samples the same ids."""
    vocab = model.cfg.vocab
    shard = Sharder(mesh, rules)

    def fused_serve_step(params, caches, tokens, block_tables, context_lens, slot_f32,
                         slot_i32, *g, sampled: Optional[bool] = None):
        """One batched decode token per active slot, sampled on the device
        (_fused_decode). ``sampled`` is the host's knowledge of whether any
        slot has temperature > 0 (None: one read of the device). With
        ``grammar`` the step takes three more arguments, gstate (B,), gmask
        and gtrans (S, vocab). Returns (next_tokens (B,) int32, logits (B,
        Vp), new_lens (B,), caches, chosen_lp (B,) f32[, new_gstate (B,) with
        grammar][, (vals, ids) (B, logprobs_k) when logprobs_k])."""
        out = _fused_decode(model, kv_spec, vocab, params, caches, tokens, block_tables,
                            context_lens, slot_f32, slot_i32, sampled,
                            grammar=tuple(g) if grammar else None, block_pages=block_pages,
                            shard=shard)
        if not logprobs_k:
            return out
        return out + (top_logprobs(out[1], vocab, logprobs_k),)

    return fused_serve_step


def make_paged_serve_multistep(model, k_steps: int, kv_spec=None, logprobs_k: int = 0,
                               grammar: bool = False, block_pages: Optional[int] = None,
                               mesh=None, rules=None):
    """K fused decode iterations in one dispatch: a host loop of K
    _fused_decode calls with no device-to-host transfer inside it (the
    reference's ``lax.scan``). Legal only over an event-free horizon
    (Scheduler.event_free_horizon): no admission, no page append past owned
    capacity, no CoW, no max-token finish within K, so the loop never needs
    the host. Each sampled token feeds the next iteration's embedding lookup,
    and the lengths and (with ``grammar``) the per-slot automaton states
    advance on the device, as the reference's scan carry does. On a mesh
    (``mesh``, ``rules``) the collectives are device work: the loop still
    makes no device-to-host transfer."""
    vocab = model.cfg.vocab
    shard = Sharder(mesh, rules)

    def fused_multistep(params, caches, tokens, block_tables, context_lens, slot_f32,
                        slot_i32, *g, sampled: Optional[bool] = None):
        """Returns (tokens (K, B) int32, last_tokens (B,), new_lens (B,),
        caches, chosen_lps (K, B) f32[, gstate (B,) with grammar][, (vals,
        ids) (K, B, logprobs_k) when logprobs_k]), all on the device, for one
        fetch. ``sampled`` as in the single step; None reads the device once,
        before the loop."""
        if sampled is None:
            sampled = bool((slot_f32[0] > 0).any())
        gstate = g[0] if grammar else None
        toks, lps, vals, ids = [], [], [], []
        for _ in range(k_steps):
            out = _fused_decode(
                model, kv_spec, vocab, params, caches, tokens, block_tables, context_lens,
                slot_f32, slot_i32, sampled,
                grammar=(gstate, g[1], g[2]) if grammar else None, block_pages=block_pages,
                shard=shard,
            )
            tokens, logits, context_lens, caches, lp = out[:5]
            if grammar:
                gstate = out[5]
            toks.append(tokens)
            lps.append(lp)
            if logprobs_k:
                v, i = top_logprobs(logits, vocab, logprobs_k)
                vals.append(v)
                ids.append(i)
        out = (torch.stack(toks), tokens, context_lens, caches, torch.stack(lps))
        if grammar:
            out = out + (gstate,)
        if logprobs_k:
            out = out + ((torch.stack(vals), torch.stack(ids)),)
        return out

    return fused_multistep


def make_chunked_prefill_step(model, kv_spec=None, mesh=None, rules=None):
    shard = Sharder(mesh, rules)

    def chunk_prefill_step(params, caches, tokens, block_tables, write_tables, cursors,
                           n_new, last_index):
        """One prefill chunk per row: tokens (B, C) -> (logits (B, Vp) at
        last_index, caches updated in place). ``block_tables`` is the read view
        (shared prefix included), ``write_tables`` the write view."""
        return model.decode_step_paged(
            params, caches, tokens, block_tables, cursors, kv_spec=kv_spec,
            write_tables=write_tables, n_new=n_new, last_index=last_index, shard=shard,
        )

    return chunk_prefill_step


def make_prefill(model, mesh=None, rules=None, max_len: Optional[int] = None,
                 attn_impl: str = "auto"):
    """Monolithic prefill; with ``max_len`` the dense caches are padded to it
    (the capacity ``make_serve_step`` decodes into). ``batch_inputs`` carries
    the encoder-decoder / vision context ({"frames"} or {"image_embeds"},
    through ``Model.encode_ctx``), whose K/V the caches then hold. With
    ``mesh`` and ``rules`` the prefill runs on the mesh: the caches come back
    as DTensors laid out by the rules (``Model.prefill(shard=)``), the
    logits whole on every rank."""
    shard = Sharder(mesh, rules)

    def prefill(params, tokens, batch_inputs=None, last_index=None):
        return model.prefill(params, tokens, batch_inputs=batch_inputs, max_len=max_len,
                             last_index=last_index, attn_impl=attn_impl, shard=shard)

    return prefill
