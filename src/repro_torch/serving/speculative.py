"""Speculative decoding inside the fused window: n-gram drafts, one verify
call a window, lens-rollback accept.

Port of ``repro.serving.speculative``. Speculation needs no new memory format,
only a new iteration over the paged view:

  * propose: a per-slot n-gram hash table over the request's own prompt and
    generated tokens proposes K tokens (prompt-lookup decoding). No second
    model: two gathers and a hash on the device.
  * verify: one chunk-attention call scores all K draft positions against
    the paged past; its present is [current token, draft]
    (``Model.decode_step_paged(spec_verify=True)``, the chunk kernel at
    C = K + 1 and any cursor alignment).
  * accept: the longest draft prefix the target agrees with, plus one
    correction or bonus token (``kernels.ops.verify_draft_tokens``).
  * rollback: positions past the accepted length are not covered by the
    advanced ``lens``, and later appends overwrite them. The scheduler
    reserved the window's pages beforehand
    (``Scheduler.reserve_decode_tokens``), so no append needs the host.

``make_paged_serve_spec_multistep`` runs S such windows in one dispatch, a
host loop with no device-to-host transfer inside it, the proposer's ``hist``
and ``table`` updated on the device beside the lens mirror; the host makes
one (S, B, C) fetch for up to S * (K + 1) tokens a slot.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops

from .step import top_logprobs

# FNV-1a over int32 token ids in uint32 arithmetic, the same in NumPy (the
# host rebuild) and in torch (the device insert): the table must be a pure
# function of the token context, so the two forms agree bit for bit. torch
# has no uint32 multiply on every device: its form holds the uint32 values
# in int64 and masks to 32 bits after each step (a product < 2**57).
_FNV_INIT = 2166136261
_FNV_MULT = 16777619
_M32 = 0xFFFFFFFF


def ngram_keys_torch(grams: torch.Tensor, table_size: int) -> torch.Tensor:
    """grams (..., g) integer -> (...,) int64 bucket in [0, table_size)."""
    h = torch.full(grams.shape[:-1], _FNV_INIT, dtype=torch.int64, device=grams.device)
    for i in range(grams.shape[-1]):
        h = ((h ^ (grams[..., i].long() & _M32)) * _FNV_MULT) & _M32
    return h & (table_size - 1)


def ngram_keys_np(grams: np.ndarray, table_size: int) -> np.ndarray:
    """NumPy form of ngram_keys_torch: the same buckets, as int32."""
    grams = np.asarray(grams, np.int32)
    h = np.full(grams.shape[:-1], _FNV_INIT, np.uint32)
    with np.errstate(over="ignore"):
        for i in range(grams.shape[-1]):
            h = (h ^ grams[..., i].astype(np.uint32)) * np.uint32(_FNV_MULT)
    return (h & np.uint32(table_size - 1)).astype(np.int32)


class DraftProposer:
    """Protocol for speculative draft sources.

    A proposer owns two per-slot device arrays, ``hist`` (hist[b, i] = the
    sequence's token at position i) and ``table`` (its index over hist),
    which persist across dispatches beside the lens mirror:

      rebuild_row(context)         host: (hist_row, table_row) from a token
                                   list (admission, preemption, plain steps)
      propose(hist, table, lens, active)          device: -> draft (B, K)
      update(hist, table, lens, tokens_out,
             committed, active)                   device: fold one verified
                                                  window in
    """

    spec_tokens: int

    def rebuild_row(self, context) -> Tuple[np.ndarray, np.ndarray]:
        raise NotImplementedError

    def propose(self, hist, table, lens, active):
        raise NotImplementedError

    def update(self, hist, table, lens, tokens_out, committed, active):
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class NGramProposer(DraftProposer):
    """Prompt-lookup drafting: propose the K tokens that followed the most
    recent earlier occurrence of the current ``ngram``-gram.

    ``table[b, key]`` holds the end position q of the latest n-gram hashing to
    ``key`` (0 = empty: position 0 never ends a gram since ngram >= 2); column
    ``table_size`` is a dump slot for masked writes. The gram ending at q is
    inserted only once token q + 1 is known, so a lookup finds a strictly
    earlier occurrence with a known continuation, never the suffix being
    extended. Collisions only make a wrong draft, which verify rejects (the
    stored gram is re-checked against the key gram too). hist and table are
    pure functions of the token context: rebuild_row equals the device's
    insertion history.
    """

    spec_tokens: int
    ngram: int = 2
    table_size: int = 512
    vocab: int = 32000
    hist_len: int = 0

    def __post_init__(self):
        if self.ngram < 2:
            raise ValueError("spec_ngram must be >= 2 (a 1-gram lookup would "
                             "match its own last token)")
        if self.table_size & (self.table_size - 1):
            raise ValueError("spec_table_size must be a power of two")
        if self.hist_len <= 0:
            raise ValueError("hist_len must cover max context + window")

    # ---- host (the rebuild path) ---------------------------------------------
    def rebuild_row(self, context) -> Tuple[np.ndarray, np.ndarray]:
        """context: the request's prompt + generated tokens (the current token
        last). Replays the device's insertion order: the gram ending at q for
        q = ngram - 1 .. n - 2 ascending, the last write winning a bucket."""
        toks = np.asarray(list(context), np.int32)
        n = len(toks)
        hist = np.zeros(self.hist_len, np.int32)
        hist[:n] = toks[:self.hist_len]
        table = np.zeros(self.table_size + 1, np.int32)
        g = self.ngram
        if n >= g + 1:
            ends = np.arange(g - 1, n - 1)
            grams = np.stack([toks[ends - (g - 1) + i] for i in range(g)], axis=-1)
            keys = ngram_keys_np(grams, self.table_size)
            for q, key in zip(ends, keys):
                table[int(key)] = int(q)
        return hist, table

    # ---- device (the window path) --------------------------------------------
    def _grams(self, hist: torch.Tensor, ends: torch.Tensor) -> torch.Tensor:
        """(B, g) the g-grams of hist ending at ``ends`` (B,), clamped."""
        offs = torch.arange(-self.ngram + 1, 1, device=hist.device)
        idx = (ends.long()[:, None] + offs[None, :]).clamp(0, hist.shape[1] - 1)
        return hist.gather(1, idx)

    def propose(self, hist, table, lens, active):
        """-> draft (B, K) int32. lens[b] is the current token's position (the
        last known index of hist); the key is the g-gram ending there."""
        g = self.ngram
        grams = self._grams(hist, lens)
        key = ngram_keys_torch(grams, self.table_size)
        cand = table.gather(1, key[:, None])[:, 0]  # (B,) end of the match
        ok = (cand > 0) & (cand < lens) & (cand >= g - 1)
        ok = ok & (self._grams(hist, cand) == grams).all(dim=1) & (active > 0)
        didx = cand.long()[:, None] + torch.arange(1, self.spec_tokens + 1,
                                                    device=hist.device)[None, :]
        draft = hist.gather(1, didx.clamp(0, hist.shape[1] - 1))
        draft = draft.clamp(0, self.vocab - 1)
        return torch.where(ok[:, None], draft, torch.zeros_like(draft))

    def update(self, hist, table, lens, tokens_out, committed, active):
        """Fold a verified window in, in place: write the window's tokens at
        positions lens + 1 .. (rows past ``committed`` are overwritten by the
        next window, which starts at the new lens + 1), then insert the grams
        whose continuation became known (ends q = lens + j, j < committed).
        An inactive row's write starts at hist_len, clamped to hist_len - C,
        as the reference's dynamic_update_slice clamps it."""
        b, hl = hist.shape
        c = tokens_out.shape[1]
        start = torch.where(active > 0, lens + 1, torch.full_like(lens, hl))
        start = start.long().clamp(0, hl - c)
        cols = start[:, None] + torch.arange(c, device=hist.device)[None, :]
        hist.scatter_(1, cols, tokens_out.to(hist.dtype))
        rows = torch.arange(b, device=hist.device)
        dump = torch.full_like(lens, self.table_size).long()
        for j in range(c):
            q = lens + j
            key = ngram_keys_torch(self._grams(hist, q), self.table_size)
            valid = (j < committed) & (active > 0) & (q >= self.ngram - 1)
            table[rows, torch.where(valid, key, dump)] = q.to(table.dtype)
        return hist, table


@dataclasses.dataclass(frozen=True)
class ModelDraftProposer(DraftProposer):
    """Drafting by a small registry model behind the same protocol, a stub as
    in the reference: construction is allowed so configs can name it; use
    raises."""

    spec_tokens: int
    draft_model: str = ""

    def _todo(self):
        raise NotImplementedError(
            "registry-draft-model speculation is stubbed behind DraftProposer; "
            "use NGramProposer (EngineConfig.spec_tokens) for now"
        )

    def rebuild_row(self, context):
        self._todo()

    def propose(self, hist, table, lens, active):
        self._todo()

    def update(self, hist, table, lens, tokens_out, committed, active):
        self._todo()


def make_paged_serve_spec_multistep(model, windows: int, proposer, kv_spec=None,
                                    logprobs_k: int = 0, mesh=None, rules=None):
    """S speculative windows in one dispatch, the speculative sibling of
    step.make_paged_serve_multistep: a host loop of S windows with no
    device-to-host transfer inside it.

    Each window proposes K draft tokens from the n-gram table, runs one
    verify pass (decode_step_paged(spec_verify=True)), accepts or resamples
    with ops.verify_draft_tokens, advances ``lens`` by the committed count
    (rollback: the rejected suffix is not covered), and folds the committed
    tokens into hist / table for the next window's proposal. Legal under the
    same event-free-horizon contract as the plain multistep, with
    tokens_per_step = K + 1, and the window's pages reserved beforehand. On a
    mesh (``mesh``, ``rules``) every rank verifies on the whole logits and
    draws the same acceptances; the windows stay free of device-to-host
    transfers (the collectives are device work)."""
    from repro_torch.models.layers import Sharder

    vocab = model.cfg.vocab
    shard = Sharder(mesh, rules)
    c = proposer.spec_tokens + 1

    def spec_multistep(params, caches, tokens, block_tables, context_lens, slot_f32,
                       slot_i32, hist, table, sampled: Optional[bool] = None):
        """tokens (B,), block_tables (B, max_pages), context_lens (B,),
        slot_f32 (2, B), slot_i32 (3, B), hist (B, L), table (B, H + 1) (both
        updated in place). ``sampled`` as in the fused step (None reads the
        device once, before the loop). Returns (tokens (S, B, C) int32,
        committed (S, B) int32, last (B,) int32, new_lens (B,), caches,
        chosen_lps (S, B, C) f32, hist, table[, (vals, ids) (S, B, C, k)
        when logprobs_k]), all on the device."""
        active = slot_i32[0]
        if sampled is None:
            sampled = bool((slot_f32[0] > 0).any())
        b = tokens.shape[0]
        rows = torch.arange(b, device=tokens.device)
        toks, lens = tokens, context_lens
        outs, comms, lps, vals, ids = [], [], [], [], []
        for _ in range(windows):
            draft = proposer.propose(hist, table, lens, active)  # (B, K)
            present = torch.cat([toks[:, None], draft.to(toks.dtype)], dim=1)  # (B, C)
            logits, caches = model.decode_step_paged(
                params, caches, present, block_tables, lens, kv_spec=kv_spec, active=active,
                spec_verify=True, shard=shard,
            )  # (B, C, Vp)
            tok_out, committed, lp = ops.verify_draft_tokens(
                logits, draft, slot_f32[0], slot_i32[1], slot_f32[1], slot_i32[2], lens + 1,
                active, vocab=vocab, sampled=sampled,
            )
            last = tok_out[rows, (committed - 1).clamp(min=0).long()]
            hist, table = proposer.update(hist, table, lens, tok_out, committed, active)
            toks = torch.where(active > 0, last, toks)
            lens = lens + committed.to(lens.dtype)
            outs.append(tok_out)
            comms.append(committed)
            lps.append(lp)
            if logprobs_k:
                v, i = top_logprobs(logits.reshape(b * c, -1), vocab, logprobs_k)
                vals.append(v.reshape(b, c, -1))
                ids.append(i.reshape(b, c, -1))
        out = (torch.stack(outs), torch.stack(comms), toks, lens, caches, torch.stack(lps),
               hist, table)
        if logprobs_k:
            out = out + ((torch.stack(vals), torch.stack(ids)),)
        return out

    return spec_multistep
