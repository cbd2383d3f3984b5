"""GenerationParams / Sequence / RequestHandle — the generation API.

Port of ``repro.serving.params`` for single-branch generation, with top-k
logprobs (``logprobs``, up to ``EngineConfig.logprobs_k``) and speculative
decoding (``speculative``). The parallel-generation fields keep their names
but are refused at construction until their slice is ported (ROADMAP Queue 1
item 2): ``n > 1``, ``beam_width`` and ``grammar``.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

from .sampling import SamplingParams

_LATER = ("is not ported yet (ROADMAP Queue 1 item 2: best-of-n, beam search, "
          "constrained decoding)")


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
    n: int = 1
    beam_width: int = 0
    grammar: Optional[Any] = None
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
        if self.n > 1:
            raise NotImplementedError(f"n > 1 (best-of-n) {_LATER}")
        if self.beam_width:
            raise NotImplementedError(f"beam_width (beam search) {_LATER}")
        if self.grammar is not None:
            raise NotImplementedError(f"grammar (constrained decoding) {_LATER}")

    @property
    def sampling(self) -> SamplingParams:
        return SamplingParams(
            temperature=self.temperature, top_k=self.top_k, top_p=self.top_p, seed=self.seed,
        )


FINISH_EOS = "eos"
FINISH_LENGTH = "length"
FINISH_ERROR = "error"


@dataclasses.dataclass
class Sequence:
    """One generated branch: tokens, the top-k logprobs per generated-token
    index (``[(token_id, logprob), ...]``, empty unless the request asked for
    them), the cumulative log-probability of the chosen tokens, and why it
    stopped ("eos" | "length" | "error" | None)."""

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
