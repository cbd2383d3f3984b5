"""Requests, branch groups, their engine-side state, and the FIFO admission
queue.

Port of ``repro.serving.engine.request``: a Request names WHAT to generate
from (rid, prompt, arrival time), its GenerationParams HOW; a RequestState
tracks one branch of a request through the engine. A request that asks for
parallel generation (n > 1 or beam_width > 0) expands into a BranchGroup of
RequestStates, one a branch, that the scheduler admits and preempts as a unit
and whose block-table rows fork one prompt's pages (``cache.fork_slot``).
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Deque, Dict, List, Optional, Sequence as Seq, Tuple

from repro_torch.serving.params import FINISH_EOS, FINISH_LENGTH, GenerationParams, Sequence
from repro_torch.serving.sampling import SamplingParams


def page_hash_chain(tokens: Seq[int], page_size: int) -> List[Tuple]:
    """Chain hashes of page-granular token chunks — the prefix-sharing keys.

    Entry ``i`` identifies the content of logical page ``i`` given everything
    before it, so equal keys imply equal full token prefixes. A trailing
    partial chunk gets a final entry keyed by its exact tokens (identical
    prompts share even their partial last page; copy-on-write resolves the
    first divergent append)."""
    chain: List[Tuple] = []
    h: Tuple = ("kv-prefix", page_size)
    n_full = len(tokens) // page_size
    for i in range(n_full):
        h = (hash(h), tuple(int(t) for t in tokens[i * page_size:(i + 1) * page_size]))
        chain.append(h)
    rem = tokens[n_full * page_size:]
    if rem:
        chain.append((hash(h), tuple(int(t) for t in rem), "partial"))
    return chain


class Request:
    """One generation request: identity (rid), prompt, arrival time and policy."""

    def __init__(self, rid: int, prompt: Seq[int], params: Optional[GenerationParams] = None,
                 *, arrival_time: float = 0.0):
        self.rid = int(rid)
        self.prompt = [int(t) for t in prompt]
        self.params = params if params is not None else GenerationParams()
        self.arrival_time = float(arrival_time)
        if not self.prompt:
            raise ValueError("empty prompt")

    @property
    def max_new_tokens(self) -> int:
        return self.params.max_new_tokens

    @property
    def eos_id(self) -> Optional[int]:
        return self.params.eos_id

    @property
    def sampling(self) -> SamplingParams:
        return self.params.sampling

    @property
    def logprobs(self) -> int:
        return self.params.logprobs

    def __repr__(self):
        return f"Request(rid={self.rid}, prompt=<{len(self.prompt)} tokens>, params={self.params})"


# RequestState.phase values: QUEUED -> PREFILLING (admitted, context KV
# materializing chunk by chunk, or a group sibling awaiting the fork of its
# primary's pages, or a beam branch held for the joint selection) ->
# DECODING (context resident, one token per step). The monolithic engine
# admits and prefills in one step.
QUEUED = "queued"
PREFILLING = "prefilling"
DECODING = "decoding"


@dataclasses.dataclass
class RequestState:
    """Engine-side lifecycle of one BRANCH of a request (survives
    preemption). A plain n=1 request is a single branch with no group."""

    request: Request
    generated: List[int] = dataclasses.field(default_factory=list)
    # generated-token index -> [(token_id, logprob), ...] of the top
    # request.logprobs candidates at that position (empty unless requested);
    # keyed by token index, so preemption-recompute overwrites in place
    logprobs: Dict[int, List[Tuple[int, float]]] = dataclasses.field(default_factory=dict)
    slot: Optional[int] = None  # batch slot while running, None while queued
    # chunked prefill: tokens of context whose KV is computed and resident for
    # the current residency; None once the prefill completes (or always, in
    # the monolithic engine). Preemption resets it (recompute policy).
    chunk_cursor: Optional[int] = None
    admit_time: Optional[float] = None
    first_token_time: Optional[float] = None
    finish_time: Optional[float] = None
    n_preemptions: int = 0
    error: Optional[str] = None  # set when the engine fails the request
    finish_reason: Optional[str] = None  # "eos" | "length" | "error"; None while running
    # sum of log P(token | prefix) over generated tokens, under the unmasked
    # distribution (best-of-n's per-branch score; beam search keeps it
    # through its own candidates)
    cum_logprob: float = 0.0
    # parallel generation: the group and the branch index (branch 0 is the
    # PRIMARY: it prefills the prompt, the siblings fork its pages)
    group: Optional["BranchGroup"] = None
    branch: int = 0
    # a fresh sibling with a slot and no pages, waiting for its primary's
    # prefill to complete so it can fork the prompt pages: masked out of the
    # chunk scheduler and the batched decode
    await_fork: bool = False
    # beam search: this branch's candidates wait in the group's pending_rows
    # for the joint selection (re-admitted branches finish their recompute
    # prefills on different steps): masked out of decode, pages resident
    hold: bool = False
    # constrained decoding: the branch's GLOBAL state id in the engine's
    # stacked grammar tables (None = unconstrained), the host mirror of the
    # device's per-slot state vector
    grammar_state: Optional[int] = None
    # memoized prefix-sharing keys for (page_size, len(context))
    _chain_key: Optional[Tuple[int, int]] = dataclasses.field(default=None, repr=False,
                                                              compare=False)
    _chain: List[Tuple] = dataclasses.field(default_factory=list, repr=False, compare=False)

    def hash_chain(self, page_size: int) -> List[Tuple]:
        """Prefix-sharing keys of the context as it would be (re-)prefilled
        now; recomputed only when the context has grown."""
        key = (page_size, len(self.context))
        if self._chain_key != key:
            self._chain_key = key
            self._chain = page_hash_chain(self.context, page_size)
        return self._chain

    @property
    def context(self) -> List[int]:
        """Tokens that must be in the KV cache: prompt + everything generated
        (after preemption all of it is re-prefilled)."""
        return self.request.prompt + self.generated

    @property
    def sampling(self) -> SamplingParams:
        """The branch's EFFECTIVE sampling policy: branch b draws from the
        stream of seed + b, so it is token-exact with a serial n=1 request
        submitted with that seed and the same rid."""
        sp = self.request.sampling
        if self.branch:
            sp = dataclasses.replace(sp, seed=sp.seed + self.branch)
        return sp

    @property
    def phase(self) -> str:
        """QUEUED / PREFILLING / DECODING: a PREFILLING slot receives prefill
        chunks (or, awaiting a fork or held for a beam step, nothing) and is
        masked out of the batched decode."""
        if self.slot is None:
            return QUEUED
        if self.chunk_cursor is not None or self.await_fork or self.hold:
            return PREFILLING
        return DECODING

    def release(self) -> None:
        """Drop residency on preemption or finish: the slot and the cursor
        (recompute policy). A fresh sibling goes back to awaiting its fork; a
        started one re-prefills its own context."""
        self.slot = None
        self.chunk_cursor = None
        self.hold = False
        self.await_fork = self.group is not None and self.branch > 0 and not self.generated

    @property
    def done(self) -> bool:
        if self.finish_reason is not None:
            return True
        if len(self.generated) >= self.request.max_new_tokens:
            return True
        eos = self.request.eos_id
        return eos is not None and bool(self.generated) and self.generated[-1] == eos

    def finished_reason(self) -> str:
        """The reason ``done`` holds (stamped on first call)."""
        if self.finish_reason is None:
            eos = self.request.eos_id
            self.finish_reason = (
                FINISH_EOS if eos is not None and self.generated and self.generated[-1] == eos
                else FINISH_LENGTH
            )
        return self.finish_reason

    def own_sequence(self) -> Sequence:
        return Sequence(tokens=list(self.generated), logprobs=dict(self.logprobs),
                        cumulative_logprob=self.cum_logprob, finish_reason=self.finish_reason)

    @property
    def sequences(self) -> List[Sequence]:
        """The request's per-branch results: a one-element list for a plain
        request, the group's branches (or best beam hypotheses) otherwise.
        The engine's results map rid -> the primary state."""
        if self.group is not None:
            return self.group.sequences()
        return [self.own_sequence()]


class BranchGroup:
    """The branches of one request, admitted and preempted as a unit and
    aliasing one prompt's pages. mode "sample" (best-of-n: branches decode
    independently on forked streams) or "beam" (a joint selection each step
    and block-table row reorders)."""

    def __init__(self, request: Request):
        self.request = request
        self.mode = "beam" if request.params.beam_width else "sample"
        self.branches: List[RequestState] = [
            RequestState(request, group=self, branch=b, await_fork=b > 0)
            for b in range(request.params.n_branches)
        ]
        # beam search: hypotheses that reached eos, ranked by cumulative_logprob
        self.finished: List[Sequence] = []
        # beam search: branch -> its top-k candidate row (vals, ids), collected
        # until every live branch has reported
        self.pending_rows: Dict[int, Tuple] = {}

    @property
    def primary(self) -> RequestState:
        return self.branches[0]

    @property
    def n_branches(self) -> int:
        return len(self.branches)

    @property
    def all_done(self) -> bool:
        return all(st.done for st in self.branches)

    def sequences(self) -> List[Sequence]:
        if self.mode == "beam":
            ranked = sorted(self.finished, key=lambda s: -s.cumulative_logprob)
            return ranked[:self.request.params.n]
        return [st.own_sequence() for st in self.branches]


class RequestQueue:
    """FIFO with front-requeue for preempted requests."""

    def __init__(self):
        self._q: Deque[RequestState] = deque()

    def push(self, state: RequestState) -> None:
        self._q.append(state)

    def requeue_front(self, state: RequestState) -> None:
        self._q.appendleft(state)

    def peek(self) -> Optional[RequestState]:
        return self._q[0] if self._q else None

    def pop(self) -> RequestState:
        return self._q.popleft()

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)
