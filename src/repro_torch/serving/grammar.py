"""Token-level grammars for constrained decoding (the host-side compiler).

Port of ``repro.serving.grammar``, copied (numpy only; the port imports
nothing of the reference). Constrained decoding is a logit-mask stage of the
device sampler (``kernels.ops.sample_tokens(mask=)``): the host computes,
once a grammar, one additive mask row a state (0 = allowed, ``MASK_OFF`` =
disallowed) and an int32 transition table; the engine stacks them into
fixed-shape device tables, and the fused decode step gathers each slot's row
and advances each slot's state by the token it just sampled, on the device,
so a fused K-step window makes no device-to-host transfer for it.

A grammar is a ``TokenDFA``, a deterministic automaton over token ids. Every
state must allow at least one token; termination is an accepting state that
allows only the eos token, so a complete sequence finishes through the
ordinary EOS path (finish_reason "eos").

``json_array_dfa`` / ``fixed_json_array_dfa`` are the reference's test
grammars: JSON arrays of integers over a caller-supplied char -> token map.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

# additive logit penalty for disallowed tokens: large and finite (a -inf mask
# could meet a -inf pad column and make softmax arithmetic produce NaNs; at
# -1e30 the token simply never wins an argmax or survives a softmax)
MASK_OFF = -1.0e30


class TokenDFA:
    """A deterministic finite automaton over token ids.

    ``transitions`` is one dict per state mapping allowed token id -> next
    state; a token absent from the dict is DISALLOWED in that state. State 0 is
    the initial state. ``vocab`` bounds the token alphabet (ids must be < vocab
    — the model's true vocabulary, before any padding).
    """

    def __init__(self, vocab: int, transitions: Sequence[Dict[int, int]]):
        n_states = len(transitions)
        if n_states < 1:
            raise ValueError("a TokenDFA needs at least one state")
        if vocab < 1:
            raise ValueError(f"vocab must be >= 1, got {vocab}")
        self.vocab = int(vocab)
        self.n_states = n_states
        # mask rows (S, vocab) f32 and transition table (S, vocab) i32; the
        # transition of a disallowed token is a self-loop (never taken — the
        # mask keeps the sampler from ever choosing it)
        self.mask = np.full((n_states, vocab), MASK_OFF, np.float32)
        self.next_state = np.tile(
            np.arange(n_states, dtype=np.int32)[:, None], (1, vocab)
        )
        for s, row in enumerate(transitions):
            if not row:
                raise ValueError(
                    f"state {s} allows no tokens — it would mask the whole vocab"
                )
            for tok, nxt in row.items():
                if not 0 <= int(tok) < vocab:
                    raise ValueError(f"token {tok} outside vocab [0, {vocab})")
                if not 0 <= int(nxt) < n_states:
                    raise ValueError(
                        f"state {s}: transition on {tok} -> {nxt} outside "
                        f"[0, {n_states})"
                    )
                self.mask[s, int(tok)] = 0.0
                self.next_state[s, int(tok)] = int(nxt)

    def allows(self, state: int, token: int) -> bool:
        return bool(self.mask[state, token] == 0.0)

    def step(self, state: int, token: int) -> int:
        """Host-side transition (mirrors the device gather bit-for-bit)."""
        return int(self.next_state[state, token])

    def state_after(self, tokens: Sequence[int]) -> int:
        """Replay a generated sequence from the initial state — how the engine
        reconstructs a branch's grammar state after preemption-recompute."""
        s = 0
        for t in tokens:
            s = self.step(s, int(t))
        return s

    def valid_prefix(self, tokens: Sequence[int]) -> bool:
        """True when every token was allowed by the state it was emitted from
        — the invariant a masked sampler can never violate."""
        s = 0
        for t in tokens:
            if not self.allows(s, int(t)):
                return False
            s = self.step(s, int(t))
        return True


JSON_ARRAY_CHARS = "[],0123456789"


def json_array_dfa(charmap: Dict[str, int], eos_id: int, vocab: int) -> TokenDFA:
    """Arrays of non-negative integers — ``[]``, ``[7]``, ``[10,0,42]`` — with
    JSON's no-leading-zero number rule. ``charmap`` maps each char of
    ``JSON_ARRAY_CHARS`` to a token id. Unbounded: a sampled walk may run to
    the length cap mid-array (finish_reason "length"); any walk that reaches
    eos parses. States: 0 start, 1 after '[', 2 in a multi-digit number,
    3 after ',', 4 after a lone '0', 5 accept (eos only)."""
    c = {ch: int(charmap[ch]) for ch in JSON_ARRAY_CHARS}
    digits19 = {c[d]: 2 for d in "123456789"}
    t: List[Dict[int, int]] = [
        {c["["]: 1},                                     # 0: start
        {**digits19, c["0"]: 4, c["]"]: 5},              # 1: after '['
        {**{c[d]: 2 for d in "0123456789"},              # 2: in a number
         c[","]: 3, c["]"]: 5},
        {**digits19, c["0"]: 4},                         # 3: after ','
        {c[","]: 3, c["]"]: 5},                          # 4: lone '0'
        {int(eos_id): 5},                                # 5: accept -> eos
    ]
    return TokenDFA(vocab, t)


def fixed_json_array_dfa(charmap: Dict[str, int], eos_id: int, vocab: int,
                         n_items: int = 3) -> TokenDFA:
    """Exactly ``n_items`` single-digit integers — a BOUNDED language, so every
    constrained generation with budget >= 2*n_items + 2 tokens terminates at
    eos and parses. The tests' 100%-valid-JSON law uses this grammar."""
    if n_items < 1:
        raise ValueError("n_items must be >= 1")
    c = {ch: int(charmap[ch]) for ch in JSON_ARRAY_CHARS}
    digits = {c[d] for d in "0123456789"}
    t: List[Dict[int, int]] = [{c["["]: 1}]
    for i in range(n_items):
        after_digit = len(t) + 1
        t.append({d: after_digit for d in digits})       # expect digit i
        if i < n_items - 1:
            t.append({c[","]: after_digit + 1})          # expect ','
        else:
            t.append({c["]"]: after_digit + 1})          # expect ']'
    t.append({int(eos_id): len(t)})                      # accept -> eos
    return TokenDFA(vocab, t)
