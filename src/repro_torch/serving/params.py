"""GenerationParams / Sequence / RequestHandle — the generation API.

Port of ``repro.serving.params``: top-k logprobs (``logprobs``, up to
``EngineConfig.logprobs_k``), speculative decoding (``speculative``), and the
parallel-generation axes:

  - ``n`` > 1: best-of-n sampling. The engine admits the n branches as a
    group whose block-table rows fork the prompt's pages (``cache.fork_slot``;
    copy-on-write privatizes a shared page on the first divergent write).
    Branch b draws from the stream of seed + b, so it is token-exact with a
    serial n=1 request at seed + b with the same rid.
  - ``beam_width`` >= 2: beam search. Deterministic (temperature / top_k /
    top_p stay at their defaults, validated here); each step rebinds whole
    block-table rows (``cache.reorder_rows``), hypotheses ending in eos move
    to the finished pool, and the best ``n`` come back.
  - ``grammar``: constrained decoding (``serving.grammar.TokenDFA``), an
    additive logit mask in the device sampler.

Incompatible combinations fail at construction (``__post_init__``) or in the
engine's ``submit``, never mid-step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .grammar import TokenDFA
from .sampling import SamplingParams


@dataclasses.dataclass(frozen=True)
class GenerationParams:
    """How to generate (the prompt stays on the Request). Frozen and validated
    at construction."""

    max_new_tokens: int = 16
    eos_id: Optional[int] = None
    temperature: float = 0.0
    top_k: int = 0
    top_p: float = 1.0
    seed: int = 0
    # top-k logprobs returned per generated token (<= EngineConfig.logprobs_k)
    logprobs: int = 0
    n: int = 1  # sequences to return (sampling: the branch count)
    beam_width: int = 0  # 0 = off; >= 2 = beam search width
    grammar: Optional[TokenDFA] = None  # constrained decoding automaton
    # per-request logits recording: None follows EngineConfig.record_logits,
    # False opts this request out, True requires a recording engine (submit()
    # checks)
    record_logits: Optional[bool] = None
    # speculative decoding: None follows EngineConfig.spec_tokens, True
    # requires a speculating engine (submit() checks), False opts this request
    # out; any such slot makes the whole dispatch plain decode (speculation
    # is a batch-wide window)
    speculative: Optional[bool] = None

    def __post_init__(self):
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.logprobs < 0:
            raise ValueError(f"logprobs must be >= 0, got {self.logprobs}")
        if self.n < 1:
            raise ValueError(f"n must be >= 1, got {self.n}")
        _ = self.sampling  # SamplingParams validates temperature/top_k/top_p
        if self.beam_width == 1:
            raise ValueError("beam_width=1 is greedy decoding — use n=1, temperature=0")
        if self.beam_width:
            if self.beam_width < 0:
                raise ValueError(f"beam_width must be >= 0, got {self.beam_width}")
            if self.temperature != 0.0 or self.top_k != 0 or self.top_p != 1.0:
                raise ValueError(
                    "beam search is deterministic: temperature/top_k/top_p must stay at "
                    "their defaults with beam_width > 0"
                )
            if self.n > self.beam_width:
                raise ValueError(
                    f"n={self.n} sequences from a beam of {self.beam_width} — "
                    f"n must be <= beam_width"
                )
            if self.grammar is not None:
                raise ValueError(
                    "grammar-constrained beam search is not supported "
                    "(beam candidates come from the unmasked top-k)"
                )
            if self.logprobs:
                raise ValueError(
                    "per-position logprobs are not recorded under beam search "
                    "(hypothesis histories permute across steps); use the returned "
                    "cumulative_logprob"
                )
        elif self.n > 1 and self.temperature == 0.0:
            raise ValueError(
                "n>1 with temperature=0 would generate n identical greedy branches — "
                "set temperature > 0 or use beam_width"
            )
        if self.speculative:
            if self.beam_width:
                raise ValueError(
                    "speculative decoding does not compose with beam search (survivor "
                    "reorders break the event-free window); speculative=True cannot "
                    "force it — beam requests opt out automatically under speculative=None"
                )
            if self.grammar is not None:
                raise ValueError(
                    "speculative decoding does not compose with grammar-constrained "
                    "decoding (draft tokens would need the automaton advanced per "
                    "candidate); grammar requests opt out automatically under "
                    "speculative=None"
                )

    @property
    def sampling(self) -> SamplingParams:
        return SamplingParams(
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p, seed=self.seed,
        )

    @property
    def n_branches(self) -> int:
        """Batch slots a request of this shape occupies while running."""
        return self.beam_width if self.beam_width else self.n


FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_ERROR = "error"


@dataclasses.dataclass
class Sequence:
    """One generated branch: tokens, the top-k logprobs per generated-token
    index (``[(token_id, logprob), ...]``, empty unless the request asked for
    them), the cumulative log-probability of the chosen tokens under the
    unmasked distribution (a grammar constrains the selection, not the score;
    beam search ranks by it), and why it stopped ("eos" | "length" | "error" |
    None)."""

    tokens: List[int]
    logprobs: Dict[int, List[Tuple[int, float]]]
    cumulative_logprob: float
    finish_reason: Optional[str]


class RequestHandle:
    """What ``submit()`` returns: the request id plus accessors into the
    engine's results once ``run()`` completes."""

    def __init__(self, engine, rid: int):
        self._engine = engine
        self.rid = rid

    @property
    def done(self) -> bool:
        return self.rid in self._engine.results

    def result(self):
        state = self._engine.results.get(self.rid)
        if state is None:
            raise RuntimeError(f"request {self.rid} has not finished (run the engine first)")
        return state

    @property
    def sequences(self) -> List[Sequence]:
        return self.result().sequences

    def __repr__(self):
        return f"RequestHandle(rid={self.rid}, done={self.done})"
