"""ServeEngine: continuous-batching generation over a paged KV cache.

Port of ``repro.serving.engine.engine``. One engine step is a MIXED step:
(admit newcomers) then (one prefill chunk for each PREFILLING sequence,
token-budgeted) then (one batched decode step for every DECODING sequence).
A fixed-size slot vector keeps the decode step at one shape; per-slot
positions and block-table rows carry each sequence's own state into
``Model.decode_step_paged``, whose attention runs the paged kernels.

Invariants per running slot:
  - DECODING: cache.lens[slot] == len(state.context) - 1 — every context token
    except the newest generated one has its KV in the pool; the decode input
    is state.generated[-1]; and the slot owns a WRITABLE page covering
    position lens[slot] (the scheduler appends pages and copy-on-writes
    shared ones first).
  - PREFILLING (chunked mode): cache.lens[slot] == state.chunk_cursor, the
    page-aligned count of context tokens whose KV is resident; the slot is
    masked out of the batched decode (null table row, length 0).

Prefill comes in two regimes: monolithic (a newly admitted request prefills
at batch 1 on its page-padded length, plain PyTorch attention) and chunked
(``chunked_prefill=True``: the prompt advances ``chunk_tokens`` per step
through the chunk kernel, interleaved with decode). With prefix sharing, a
chunked request's first chunk starts past the pages it adopted (compute
skip). Preemption is recompute-style in both regimes.

The decode hot path stays on the device: tables and lengths live in device
mirrors beside the pools, sampling runs inside the step, and the only
per-token device-to-host traffic is one packed fetch of the sampled ids and
their log-probabilities (plus the top-k log-probability pair with
``logprobs_k``). Over a horizon the scheduler proves event-free, the engine
runs ``multi_step`` steps in one dispatch, a host loop with no transfer
inside it, and fetches their (K, B) ids once; token-exact against K = 1
because sampling folds absolute positions. With ``spec_tokens`` a dispatch
runs speculative windows instead (serving/speculative.py): an n-gram draft,
one verify pass through the chunk kernel, the longest agreeing prefix plus
one token committed, the rest rolled back by the lengths alone.

Quantization composes with all of it: ``kv_dtype`` "int8" / "int4" stores the
pages as intN bytes with per-(page, head) scales (kvquant.PagedQuantSpec), and
a model built with ``build_model(cfg, quantized=True)`` runs its MLP on int8
weights; the allocator, the prefix index and CoW never look at the bytes.

Parallel generation: a request with ``n`` > 1 or ``beam_width`` admits as a
BranchGroup. The primary prefills; at its first token (``_first_token``, the
fork hook of both prefill regimes) each sibling's row forks the primary's
pages and samples its own first token from the same logits row under its
branch seed. A beam group instead stashes each branch's top-k row (the
``logprobs_k`` pair, compiled at least ``max_beam_width + 1`` wide) and runs
the joint selection on the host (``_beam_advance``): hypotheses that hop
parents rebind whole rows (``cache.reorder_rows``), the chosen tokens become
the next inputs (the slots are re-uploaded), and eos hypotheses move to the
finished pool. Grammar-constrained decoding (``grammar_states``) keeps one
stacked (1 + grammar_states, vocab) mask table and transition table on the
device and each slot's state in a device vector the decode step advances;
the host replays the same transitions on its copy. Neither composes with
speculation (``_spec_plan``), and beam groups never fuse
(``Scheduler.event_free_horizon``). The host KV tier (``host_pool_pages``)
turns preemption into swap-out and re-admission into prefetch
(cache.TierManager); ``retain_finished_s`` keeps finished sessions there.

Perf tooling: ``record_logits`` keeps each generated token's logits row on
the host (``logits_of``; the row rides the step's one packed fetch, and
recording forces K = 1), the audit ``aligned_max_logit_err`` compares two
recording engines; ``autotune`` fills the block-shape fields left at their
auto sentinels from kernels/autotune.py's tuning table before the pool is
sized, and never overrides a pinned field.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.health import StragglerPolicy
from repro_torch.serving.params import (
    FINISH_EOS,
    FINISH_ERROR,
    FINISH_LENGTH,
    GenerationParams,
    RequestHandle,
)
from repro_torch.serving.params import Sequence as SequenceResult
from repro_torch.serving.sampling import pack_slot_params, stream_seed
from repro_torch.serving.speculative import NGramProposer, make_paged_serve_spec_multistep
from repro_torch.serving.step import (
    make_chunked_prefill_step,
    make_paged_serve_multistep,
    make_paged_serve_step,
    make_prefill,
    top_logprobs,
)
from repro_torch.serving.telemetry import EngineTrace, MetricsRegistry

from .cache import PagedKVCache
from .request import DECODING, BranchGroup, Request, RequestQueue, RequestState
from .scheduler import Scheduler, SchedulerConfig

@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_pages: int = 64
    page_size: int = 16
    max_batch: int = 8
    max_pages_per_seq: int = 16
    watermark_pages: int = 1
    prefix_sharing: bool = True
    chunked_prefill: bool = False
    chunk_tokens: int = 0  # max tokens per prefill chunk (page multiple; 0 = 2 pages, or tuned)
    step_token_quota: int = 0  # per-step token budget (0 = max_batch + chunk_tokens)
    prefill_compute_skip: bool = True  # chunked + sharing: skip adopted pages' compute
    trace: bool = False  # record lifecycle events (serving.telemetry.EngineTrace)
    trace_capacity: int = 65536
    slow_step_threshold: float = 2.0  # StragglerPolicy threshold on decode steps
    kv_dtype: str = "f32"  # "f32" | "int8" | "int4": the KV page representation
    multi_step: int = 1  # fused decode horizon K: when the scheduler proves the
    # next K steps event-free, run them as one dispatch (a host loop with no
    # device-to-host transfer) and fetch their (K, B) ids once. 1 = off;
    # token-exact for any K
    spec_tokens: int = 0  # speculative draft length K (0 = off): each decode
    # step becomes a window of an n-gram draft, one verify pass at C = K + 1
    # and the longest agreeing prefix + 1 token committed; greedy requests are
    # token-exact against spec_tokens=0. Windows fuse multi_step at a time
    # under the same horizon contract, tokens_per_step = K + 1
    spec_ngram: int = 2  # n-gram order of the draft lookup key
    spec_table_size: int = 512  # n-gram hash buckets a slot (power of two)
    spec_accept_floor: float = 2.0  # adaptive backoff: while the EMA of
    # accepted tokens a window is under this floor, the planner runs plain
    # decode for spec_backoff dispatches, then re-probes; consecutive
    # under-floor probes double the wait (capped at 32x spec_backoff). 0 = off
    spec_backoff: int = 32  # base plain-dispatch count between re-probes
    logprobs_k: int = 0  # top-k logprob width of the decode step; > 0 lets
    # requests opt in (GenerationParams.logprobs <= this), the pair riding the
    # ids fetch
    max_beam_width: int = 0  # widest beam_width a request may ask for; beam
    # candidates come from the top-k logprob pair, so the pair's width is at
    # least max_beam_width + 1 (eos is one id: at most one top entry of a row
    # is eos, so beam_width non-eos continuations always exist)
    grammar_states: int = 0  # grammar-table rows for constrained decoding (the
    # sum of TokenDFA.n_states over every grammar registered with the engine);
    # the tables have the fixed shape (1 + grammar_states, vocab), row 0 the
    # unconstrained state
    host_pool_pages: int = 0  # host-RAM page tier capacity (0 = no tier):
    # preemption demotes complete pages there and re-admission promotes them
    # back; requires prefix_sharing (the tier is a content-keyed index)
    swap_budget_pages_per_step: int = 0  # per-step host<->device migration
    # allowance, shared by demotions and promotions (0 = unlimited); overflow
    # truncates a run's tail
    retain_finished_s: float = 0.0  # on finish, demote a request's pages to
    # the host tier and keep them this many seconds (a follow-up sharing the
    # context prefetches instead of re-prefilling); 0 = don't retain
    record_logits: bool = False  # keep each generated token's logits row on the
    # host (ServeEngine.logits_of) for accuracy audits (aligned_max_logit_err).
    # A slow path: the (B, vocab) rows ride every step's fetch, and it forces
    # multi_step to 1
    autotune: bool = False  # fill the block-shape fields left at their auto
    # sentinels (page_size=0 via sized_for, decode_block_pages=0,
    # chunk_tokens=0) from kernels/autotune.py's tuning table, sweeping once on
    # a miss; pinned fields are never overridden. The decision shows in
    # metrics() (tuned_*) and as a `tuning_selected` trace instant
    decode_block_pages: int = 0  # pages per decode compute block (0 = auto:
    # tuned with autotune, unblocked otherwise); ignored by the CUDA decode
    sized_max_len: int = 0  # the max_len sized_for() was called with (0 when
    # the pool was sized by hand): autotune re-derives the pool from it when
    # page_size is deferred to the tuner

    def __post_init__(self):
        if self.spec_tokens and self.record_logits:
            raise ValueError(
                "spec_tokens does not compose with record_logits: recording needs "
                "per-step host logits rows, but the speculative window never "
                "materializes them off the device"
            )
        if self.spec_tokens < 0 or self.multi_step < 1 or self.logprobs_k < 0:
            raise ValueError(
                f"spec_tokens {self.spec_tokens} must be >= 0, multi_step "
                f"{self.multi_step} >= 1 and logprobs_k {self.logprobs_k} >= 0"
            )

    @classmethod
    def sized_for(cls, max_len: int, *, page_size: int, max_batch: int, **kw) -> "EngineConfig":
        """Pool sized so max_batch sequences of ``max_len`` tokens run with no
        contention (+1 decode-headroom page each, + the null page).
        ``page_size=0`` defers the page size to the autotuner (requires
        autotune=True): the pool is then sized at engine init from
        ``sized_max_len``, after the tuning table was consulted."""
        if page_size == 0:
            if not kw.get("autotune"):
                raise ValueError("page_size=0 requires autotune=True")
            return cls(num_pages=0, page_size=0, max_batch=max_batch, max_pages_per_seq=0,
                       sized_max_len=max_len, **kw)
        pages_per_seq = -(-max_len // page_size) + 1
        return cls(
            num_pages=max_batch * pages_per_seq + 1, page_size=page_size,
            max_batch=max_batch, max_pages_per_seq=pages_per_seq, sized_max_len=max_len, **kw,
        )


def aligned_max_logit_err(eng_ref, eng, results_ref, results) -> float:
    """Max |logit difference| between two record_logits engines over the steps
    where both saw the same context: per request, every step up to and
    including the first divergent generated token."""
    errs = [0.0]
    for rid, s_ref in results_ref.items():
        a, b = s_ref.generated, results[rid].generated
        n_cmp = min(len(a), len(b))
        div = next((i for i in range(n_cmp) if a[i] != b[i]), n_cmp - 1)
        for n in range(div + 1):
            errs.append(float(np.max(np.abs(eng_ref.logits_of[rid][n] - eng.logits_of[rid][n]))))
    return max(errs)


def _apply_tuning(config: EngineConfig, tuned) -> EngineConfig:
    """Fill every auto-sentinel block-shape field of ``config`` from a
    TunedPoint; pinned fields win. page_size=0 (sized_for deferral)
    re-derives the pool extents from sized_max_len at the tuned page size."""
    kw = {}
    if config.page_size == 0:
        if not config.sized_max_len:
            raise ValueError("page_size=0 needs EngineConfig.sized_for (sized_max_len unset)")
        ps = tuned.page_size
        pps = -(-config.sized_max_len // ps) + 1
        kw.update(page_size=ps, max_pages_per_seq=pps, num_pages=config.max_batch * pps + 1)
    if config.decode_block_pages == 0:
        kw["decode_block_pages"] = tuned.block_pages
    if config.chunked_prefill and config.chunk_tokens == 0:
        kw["chunk_tokens"] = tuned.chunk_tokens
    return dataclasses.replace(config, **kw) if kw else config


def _fetch(*parts: torch.Tensor) -> List[np.ndarray]:
    """One device-to-host copy of several tensors (integer ones as int32,
    floating ones as f32 bits, concatenated); returns numpy arrays of their
    shapes, int32 or float32."""
    flat = [(p.float().view(torch.int32) if p.is_floating_point() else p.to(torch.int32))
            .reshape(-1) for p in parts]
    host = torch.cat(flat).cpu().numpy()
    out, i = [], 0
    for p in parts:
        a = host[i:i + p.numel()].reshape(tuple(p.shape))
        i += p.numel()
        out.append(a.view(np.float32) if p.is_floating_point() else a)
    return out


def _top_pairs(vals: np.ndarray, ids: np.ndarray, n: int) -> List[Tuple[int, float]]:
    """The first ``n`` (token id, logprob) pairs of one top-k row."""
    return [(int(t), float(v)) for t, v in zip(ids[:n], vals[:n])]


def _check_pools_whole(model, cache, mesh, rules) -> None:
    """The engine keeps each rank's pools as plain tensors holding the whole
    pools, as ``serve_rules`` lay them out (kv_heads replicated): rules that
    would split a pool are refused by name."""
    from torch.distributed.tensor import Shard

    from repro_torch.core.distributed import is_placements, tree_shardings
    from repro_torch.core.tree import tree_leaves_with_path

    specs = model.paged_cache_specs(cache.num_pages, cache.page_size, kv_spec=cache.kv_spec)
    for path, pl in tree_leaves_with_path(tree_shardings(specs, mesh, rules),
                                          is_leaf=is_placements):
        if any(isinstance(p, Shard) for p in pl):
            raise NotImplementedError(
                f"page pool leaf {'/'.join(map(str, path))} would be split by these rules "
                f"({pl}); the engine serves on a mesh with whole pools (serve_rules)")


class ServeEngine:
    def __init__(self, model, params, config: EngineConfig = EngineConfig(), device=None,
                 mesh=None, rules=None):
        """``mesh`` and ``rules`` (``launch.serve_rules``) serve on a mesh:
        every rank runs this engine loop on the same requests, seeds and
        scheduling, so each makes the same host decisions; ``params`` (a
        tree every rank holds whole, or already ``distribute_params``'s
        DTensors) are laid out by the rules, each step runs on the mesh
        (``Model.decode_step_paged(shard=)``) and returns the logits whole,
        and the page pools are each rank's plain copy of the whole pools, as
        ``serve_rules`` lay them out (their kv_heads replicated: rules that
        split a pool are refused)."""
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine asked for {self.device}")
        self.model = model
        self.mesh, self.rules = mesh, rules
        if mesh is not None:
            from repro_torch.core.distributed import is_dtensor, tree_leaves
            from repro_torch.serving.step import distribute_params

            if not any(is_dtensor(t) for t in tree_leaves(params)):
                params = distribute_params(model, params, mesh, rules)
        self.params = params
        # autotune resolves the block shapes before the pool is sized: a
        # deferred page_size materializes here; a table hit is a file read
        self.tuned = None
        if config.autotune:
            from repro_torch.kernels import autotune

            self.tuned = autotune.resolve(
                model.cfg, kv_dtype=config.kv_dtype, batch=config.max_batch,
                seq_len=config.sized_max_len, page_size=config.page_size or None,
                device=self.device,
            )
            config = _apply_tuning(config, self.tuned)
        self.config = config
        if config.host_pool_pages and not config.prefix_sharing:
            raise ValueError(
                "host_pool_pages requires prefix_sharing: the host tier is a "
                "content-keyed index over the same page-hash chains"
            )
        self.cache = PagedKVCache(
            model, num_pages=config.num_pages, page_size=config.page_size,
            max_batch=config.max_batch, max_pages_per_seq=config.max_pages_per_seq,
            prefix_sharing=config.prefix_sharing, kv_dtype=config.kv_dtype,
            host_pool_pages=config.host_pool_pages,
            swap_budget_pages_per_step=config.swap_budget_pages_per_step,
        )
        if mesh is not None:
            _check_pools_whole(model, self.cache, mesh, rules)
        self.scheduler = Scheduler(
            self.cache, SchedulerConfig(config.max_batch, config.watermark_pages)
        )
        self.queue = RequestQueue()
        self._pending: List[RequestState] = []  # submitted, not yet arrived
        self.trace = EngineTrace(config.trace_capacity) if config.trace else None
        self.cache.trace = self.trace
        self.scheduler.trace = self.trace
        if self.trace is not None and self.tuned is not None:
            self.trace.instant("tuning_selected", page_size=config.page_size,
                               block_pages=config.decode_block_pages,
                               chunk_tokens=config.chunk_tokens, source=self.tuned.source)
        self.registry = MetricsRegistry()
        self._h_step = self.registry.histogram("step_time_s")
        self._h_host = self.registry.histogram("host_overhead_s")
        self._h_chunk = self.registry.histogram("chunk_time_s")
        self._c_decode = self.registry.counter("decode_steps")
        self._c_fused = self.registry.counter("fused_steps")
        self._c_pf_computed = self.registry.counter("prefill_tokens_computed")
        self._c_pf_skipped = self.registry.counter("prefill_tokens_skipped")
        self._c_slow = self.registry.counter("slow_steps")
        self._last_step_time: Optional[float] = None  # fused-horizon arrival estimate
        self._straggler = StragglerPolicy(threshold=config.slow_step_threshold)
        self._vocab = model.cfg.vocab
        # beam search selects from the top-k pair, so its width covers
        # max_beam_width + 1 even when no request asks for logprobs
        self._lp_k = max(int(config.logprobs_k),
                         config.max_beam_width + 1 if config.max_beam_width else 0)
        # constrained decoding: one stacked mask row and transition row a
        # GLOBAL grammar state, row 0 the unconstrained state (zero mask,
        # self-loops). Registration rewrites the tables' content, never their
        # shape. Each slot's state lives in a device vector the decode step
        # advances; the host replays the same transitions on its own copy.
        self._grammar_on = config.grammar_states > 0
        if self._grammar_on:
            n_rows = 1 + config.grammar_states
            self._gmask_host = np.zeros((n_rows, self._vocab), np.float32)
            self._gtrans_host = np.zeros((n_rows, self._vocab), np.int32)
            self._gmask_dev = torch.from_numpy(self._gmask_host).to(self.device)
            self._gtrans_dev = torch.from_numpy(self._gtrans_host).to(self.device)
            self._gstate_dev = torch.zeros((config.max_batch,), dtype=torch.int32,
                                           device=self.device)
            self._grammars: Dict[int, int] = {}  # id(dfa) -> global row offset
            self._grammar_refs: List[object] = []  # keeps id() unique while registered
            self._grammar_used = 0
        kv_spec = self.cache.kv_spec
        block_pages = config.decode_block_pages or None
        on_mesh = dict(mesh=mesh, rules=rules)
        self._step = make_paged_serve_step(model, kv_spec, logprobs_k=self._lp_k,
                                           grammar=self._grammar_on, block_pages=block_pages,
                                           **on_mesh)
        # recording needs every step's rows on the host, so it forces K = 1
        self._k = 1 if config.record_logits else int(config.multi_step)
        if self._k > 1:
            self._multistep = make_paged_serve_multistep(model, self._k, kv_spec,
                                                         logprobs_k=self._lp_k,
                                                         grammar=self._grammar_on,
                                                         block_pages=block_pages, **on_mesh)
        # speculative decoding (serving/speculative.py): the window step is a
        # sibling of the multistep, plus the proposer's two per-slot device
        # arrays (hist, table), updated in place by each window; rows are
        # rebuilt on the host only for slots whose context changed outside a
        # window (_spec_stale), as _sync_slot_state does for the slot vectors
        self._spec_k = int(config.spec_tokens)
        if self._spec_k:
            self._spec_windows = self._k
            # every legal position plus one full window past it, so the
            # window's history write never clamps for an active row
            hist_len = config.max_pages_per_seq * config.page_size + self._spec_k + 2
            self._proposer = NGramProposer(
                spec_tokens=self._spec_k, ngram=config.spec_ngram,
                table_size=config.spec_table_size, vocab=self._vocab, hist_len=hist_len,
            )
            self._spec_step = make_paged_serve_spec_multistep(
                model, self._spec_windows, self._proposer, kv_spec, logprobs_k=self._lp_k,
                **on_mesh,
            )
            b = config.max_batch
            self._hist_dev = torch.zeros((b, hist_len), dtype=torch.int32, device=self.device)
            self._table_dev = torch.zeros((b, config.spec_table_size + 1), dtype=torch.int32,
                                          device=self.device)
            self._spec_stale: set = set()
            # adaptive backoff: EMA of a dispatch's mean accepted tokens a
            # window, plain dispatches left before the next probe, and the
            # current (doubling) backoff length
            self._spec_accept_ema: Optional[float] = None
            self._spec_backoff_left = 0
            self._spec_backoff_len = int(config.spec_backoff)
            self._c_spec_windows = self.registry.counter("spec_windows")
            self._c_spec_backoffs = self.registry.counter("spec_backoffs")
            self._c_spec_accepted = self.registry.counter("spec_accepted_tokens")
            self._c_spec_hits = self.registry.counter("spec_draft_hits")
            self._c_spec_rollback = self.registry.counter("spec_rollback_tokens")
        self._prefill = make_prefill(model, **on_mesh)
        # per-slot device vectors for the fused step: fed-back tokens + the
        # packed policy/phase arrays (slot_f32 (2, B): temperature, top_p;
        # slot_i32 (3, B): active, top_k, seed bits). Re-uploaded only when
        # slot composition changes; otherwise the step's outputs flow back.
        b = config.max_batch
        self._tokens_dev = torch.zeros((b,), dtype=torch.int32, device=self.device)
        f32p, i32p = pack_slot_params({}, b)
        self._slot_f32 = torch.from_numpy(f32p).to(self.device)
        self._slot_i32 = torch.from_numpy(np.vstack([np.zeros((1, b), np.int32), i32p])).to(
            self.device
        )
        self._any_sampled = False
        self._slots_stale = True
        self._slot_sig: object = None
        self._chunk_tokens = 0
        if config.chunked_prefill:
            self._chunk_tokens = config.chunk_tokens or 2 * config.page_size
            if self._chunk_tokens % config.page_size:
                raise ValueError(
                    f"chunk_tokens {self._chunk_tokens} must be a multiple of page_size "
                    f"{config.page_size} (chunk boundaries are page-aligned)"
                )
            self._chunk_step = make_chunked_prefill_step(model, self.cache.kv_spec, **on_mesh)
        self.results: Dict[int, RequestState] = {}
        self._next_rid = 0
        # rid -> {n: the logits row that produced generated[n]} (record_logits),
        # keyed by token index: a recompute overwrites, engines align
        self.logits_of: Dict[int, Dict[int, np.ndarray]] = {}
        self._t0 = time.perf_counter()

    # -- submission -------------------------------------------------------------
    def _register_grammar(self, dfa) -> int:
        """Install a TokenDFA's mask and transition rows in the stacked grammar
        tables; returns its GLOBAL row offset (its state 0). Idempotent for
        one automaton instance; the tables keep their shape."""
        off = self._grammars.get(id(dfa))
        if off is not None:
            return off
        if dfa.vocab != self._vocab:
            raise ValueError(
                f"grammar compiled for vocab {dfa.vocab} but the model's is {self._vocab}"
            )
        if self._grammar_used + dfa.n_states > self.config.grammar_states:
            raise ValueError(
                f"grammar needs {dfa.n_states} states but only "
                f"{self.config.grammar_states - self._grammar_used} of "
                f"EngineConfig.grammar_states={self.config.grammar_states} "
                f"remain — raise grammar_states"
            )
        off = 1 + self._grammar_used
        self._grammar_used += dfa.n_states
        self._grammars[id(dfa)] = off
        self._grammar_refs.append(dfa)
        self._gmask_host[off:off + dfa.n_states] = dfa.mask
        self._gtrans_host[off:off + dfa.n_states] = dfa.next_state + off
        self._gmask_dev.copy_(torch.from_numpy(self._gmask_host))
        self._gtrans_dev.copy_(torch.from_numpy(self._gtrans_host))
        return off

    def submit(self, request=None, params: Optional[GenerationParams] = None, *,
               rid: Optional[int] = None, arrival_time: float = 0.0) -> RequestHandle:
        """Enqueue one request and return its handle: ``submit(Request(...))``
        or ``submit(prompt_tokens, GenerationParams(...))`` (rid auto-assigned).
        Every request the engine could never serve fails here."""
        if not isinstance(request, Request):
            if request is None:
                raise ValueError("submit() needs a Request or a prompt")
            if rid is None:
                rid = self._next_rid
            request = Request(rid, request, params, arrival_time=arrival_time)
        elif params is not None or rid is not None:
            raise ValueError("submit(Request(...)) takes no extra params/rid")
        self._next_rid = max(self._next_rid, request.rid + 1)
        p = request.params
        if p.logprobs > self._lp_k:
            raise ValueError(
                f"request {request.rid} asks for {p.logprobs} logprobs but the engine "
                f"computes logprobs_k={self._lp_k} — raise EngineConfig.logprobs_k"
            )
        if p.record_logits and not self.config.record_logits:
            raise ValueError(
                f"request {request.rid} asks for record_logits but the engine was built "
                f"with record_logits=False"
            )
        if p.speculative and not self._spec_k:
            raise ValueError(
                f"request {request.rid} asks for speculative decoding but the engine "
                f"was built with spec_tokens=0 — set EngineConfig.spec_tokens"
            )
        if p.beam_width > self.config.max_beam_width:
            raise ValueError(
                f"request {request.rid} asks for beam_width={p.beam_width} but the engine "
                f"was built with max_beam_width={self.config.max_beam_width} — raise "
                f"EngineConfig.max_beam_width"
            )
        if p.n_branches > self.config.max_batch:
            raise ValueError(
                f"request {request.rid} needs {p.n_branches} batch slots "
                f"(admitted as a unit) > max_batch {self.config.max_batch}"
            )
        if p.n_branches > 1 and self.config.record_logits:
            raise ValueError(
                "record_logits keys rows by rid — unsupported for parallel generation "
                "(n > 1 / beam_width > 0)"
            )
        grammar_off = None
        if p.grammar is not None:
            if not self._grammar_on:
                raise ValueError(
                    f"request {request.rid} carries a grammar but the engine was built "
                    f"with grammar_states=0 — set EngineConfig.grammar_states"
                )
            grammar_off = self._register_grammar(p.grammar)
        need = self.cache.pages_for(len(request.prompt) + p.max_new_tokens)
        if need > self.config.max_pages_per_seq:
            raise ValueError(
                f"request {request.rid} will need {need} pages "
                f"(prompt {len(request.prompt)} + up to {p.max_new_tokens} new) "
                f"> max_pages_per_seq {self.config.max_pages_per_seq}"
            )
        # a group's floor adds one fork-headroom page a sibling
        floor = self.cache.pages_for(len(request.prompt) + 1) + (p.n_branches - 1)
        if floor > self.config.num_pages - 1:
            raise ValueError(
                f"request {request.rid} needs {floor} pages just to admit its "
                f"{len(request.prompt)}-token prompt"
                + (f" across {p.n_branches} branches" if p.n_branches > 1 else "")
                + f", but the pool only has {self.config.num_pages - 1} usable "
                f"pages — raise num_pages"
            )
        if p.n_branches > 1:
            group = BranchGroup(request)
            for st in group.branches:
                st.grammar_state = grammar_off
            self._pending.append(group.primary)  # the siblings ride the primary
        else:
            state = RequestState(request)
            state.grammar_state = grammar_off
            self._pending.append(state)
        return RequestHandle(self, request.rid)

    def submit_all(self, requests: Sequence[Request]) -> List[RequestHandle]:
        return [self.submit(r) for r in requests]

    # -- prefill path -----------------------------------------------------------
    def _admit_and_prefill(self, now: float) -> None:
        tr = self.trace
        # a fresh sibling forks at its primary's first token, which clears
        # its await_fork: the flag is read at admission, so a sibling admitted
        # beside its primary is not prefilled as well
        to_prefill = [(slot, st) for slot, st in self.scheduler.admit(self.queue, now)
                      if not st.await_fork]
        for slot, state in to_prefill:
            ctx = state.context
            padded = self.cache.pages_for(len(ctx)) * self.cache.page_size
            if tr is not None:
                tr.instant("admit", slot, rid=state.request.rid, context=len(ctx))
                tr.begin("prefill", slot, rid=state.request.rid, tokens=padded)
            # right-pad to the page bucket; logits read at the true last position
            tokens = torch.tensor([list(ctx) + [0] * (padded - len(ctx))], dtype=torch.int32,
                                  device=self.device)
            logits, caches = self._prefill(self.params, tokens, last_index=len(ctx) - 1)
            if self.mesh is not None:  # the prompt's K/V whole, for the whole pools
                from repro_torch.core.distributed import tree_full

                caches = tree_full(caches)
            self.cache.write_prefill(slot, caches)
            self.cache.set_len(slot, len(ctx))
            self._c_pf_computed.inc(padded)
            if tr is not None:
                tr.end("prefill", slot)
            self._first_token(state, logits[0, 0])

    def _first_token(self, state: RequestState, logits_row: torch.Tensor) -> None:
        """Sample the token a completed prefill produced, on the device; only
        the id and its log-probability cross to the host. The sampled position
        is len(context), as the decode path would use for the same token.

        This is also the parallel-generation FORK HOOK of both prefill
        regimes: when a sample-mode group's primary takes its first token,
        each awaiting sibling's row forks the primary's pages
        (cache.fork_slot) and samples its own first token from the same
        logits row under its branch seed; a beam branch instead stashes its
        row's top candidates, and the joint selection runs once every live
        branch has reported (_beam_advance)."""
        grp = state.group
        if grp is not None and grp.mode == "beam":
            vals, ids = _fetch(*top_logprobs(logits_row[None], self._vocab, self._lp_k))
            grp.pending_rows[state.branch] = (vals[0], ids[0])
            state.hold = True  # masked out of decode until the joint selection
            if state.first_token_time is None:
                state.first_token_time = time.perf_counter() - self._t0
            started = [st for st in grp.branches if not st.await_fork and not st.done]
            if all(st.branch in grp.pending_rows for st in started):
                self._beam_advance(grp)
            return
        sp = state.sampling  # branch b draws from seed + b
        seed_bits = np.uint32(stream_seed(sp.seed, state.request.rid)).astype(np.int32)
        f = torch.tensor([sp.temperature, sp.top_p], dtype=torch.float32, device=self.device)
        i = torch.tensor([sp.top_k, int(seed_bits), len(state.context)], dtype=torch.int32,
                         device=self.device)
        mask = None
        if state.grammar_state is not None:
            mask = self._gmask_dev[state.grammar_state][None]
        tok = ops.sample_tokens(
            logits_row[None], f[0:1], i[0:1], f[1:2], i[1:2], i[2:3], vocab=self._vocab,
            sampled=sp.temperature > 0, mask=mask,
        )
        lp = torch.log_softmax(logits_row[:self._vocab].float(), dim=-1)[tok.long()]
        n_lp = state.request.logprobs
        # the row's top-k pair, and the row itself when recording, ride the id's fetch
        extra = top_logprobs(logits_row[None], self._vocab, self._lp_k) if n_lp else ()
        record = self._records(state)
        got = _fetch(tok, lp, *extra, *((logits_row[:self._vocab],) if record else ()))
        t = int(got[0][0])
        state.generated.append(t)
        state.cum_logprob += float(got[1][0])
        if state.grammar_state is not None:
            state.grammar_state = int(self._gtrans_host[state.grammar_state, t])
        if n_lp:
            state.logprobs[len(state.generated) - 1] = _top_pairs(got[2][0], got[3][0], n_lp)
        if record:
            self.logits_of.setdefault(state.request.rid, {})[len(state.generated) - 1] = (
                got[-1].copy())
        self._slots_stale = True  # the slot's next decode input is host-known
        if self._spec_k:
            # the proposer's rows for this slot are rebuilt from the new
            # context before its next speculative window
            self._spec_stale.add(state.slot)
        if state.first_token_time is None:
            state.first_token_time = time.perf_counter() - self._t0
        if grp is not None and state.branch == 0:
            # fork the awaiting siblings onto the primary's pages (incref, no
            # copy: CoW privatizes on the first divergent write); each samples
            # its own first token from the same row under its branch seed
            n_resident = int(self.cache.lens[state.slot])
            for sib in grp.branches[1:]:
                if sib.await_fork and not sib.done:
                    self.cache.fork_slot(state.slot, sib.slot, n_resident)
                    sib.await_fork = False
                    self._first_token(sib, logits_row)

    def _records(self, state: RequestState) -> bool:
        return self.config.record_logits and state.request.params.record_logits is not False

    # -- beam search (host-side selection, block-table reorder) -------------------
    def _beam_advance(self, group: BranchGroup) -> None:
        """One joint beam step over a group's stashed candidate rows.

        The selection is on the host (the candidates rode the top-k fetch),
        then only block-table surgery: a branch that continues itself keeps
        its slot untouched, a hypothesis that hops parents rebinds its slot's
        row to a snapshot of the parent's (cache.reorder_rows), and a
        first-step sibling forks the primary (cache.fork_slot). Candidates
        ending in eos move to the finished pool; the group completes at
        beam_width finished hypotheses or the length cap."""
        params = group.request.params
        w = params.beam_width
        eos = group.request.eos_id
        live = [st for st in group.branches if not st.done]
        started = [st for st in live if not st.await_fork]
        by_branch = {st.branch: st for st in started}
        cands = []
        for st in started:
            vals, ids = group.pending_rows[st.branch]
            for v, t in zip(vals[:w + 1], ids[:w + 1]):
                cands.append((st.cum_logprob + float(v), st.branch, int(t)))
        group.pending_rows.clear()
        # a total order: score descending, then branch, then token
        cands.sort(key=lambda c: (-c[0], c[1], c[2]))
        cont = []
        for score, b, t in cands:
            if eos is not None and t == eos:
                group.finished.append(SequenceResult(
                    tokens=list(by_branch[b].generated) + [t], logprobs={},
                    cumulative_logprob=score, finish_reason=FINISH_EOS,
                ))
                continue
            if len(cont) < w:
                cont.append((score, b, t))
        if len(group.finished) >= w or not cont:
            self._finish_beam(group, live, survivors=False)
            return
        # slot assignment, identity first: each parent's best continuation
        # keeps the parent's own slot, so a step where every branch follows
        # itself moves no row
        base = {st.branch: list(st.generated) for st in started}
        carriers = list(live)
        assign, spill = [], []
        for score, b, t in cont:
            st = by_branch[b]
            if st in carriers:
                carriers.remove(st)
                assign.append((st, st, t, score))
            else:
                spill.append((score, b, t))
        for (score, b, t), carrier in zip(spill, carriers):
            assign.append((carrier, by_branch[b], t, score))
        now = time.perf_counter() - self._t0
        forks = [(c, p) for c, p, _, _ in assign if c is not p and c.await_fork]
        reorder = {c.slot: p.slot for c, p, _, _ in assign if c is not p and not c.await_fork}
        for carrier, parent in forks:
            self.cache.fork_slot(parent.slot, carrier.slot, int(self.cache.lens[parent.slot]))
            carrier.await_fork = False
        self.cache.reorder_rows(reorder)
        for carrier, parent, t, score in assign:
            carrier.generated = base[parent.branch] + [t]
            carrier.cum_logprob = score
            carrier.hold = False
            if carrier.first_token_time is None:
                carrier.first_token_time = now
        # the rows' next inputs are the host's selection, not the device's sample
        self._slots_stale = True
        if self.trace is not None:
            self.trace.instant("beam_step", group.primary.slot, rid=group.request.rid,
                               moves=len(reorder), forks=len(forks),
                               finished=len(group.finished))
        if len(assign[0][0].generated) >= params.max_new_tokens:
            self._finish_beam(group, live, survivors=True)

    def _finish_beam(self, group: BranchGroup, live, *, survivors: bool) -> None:
        """Retire a beam group: at the length cap the live hypotheses join the
        finished pool as FINISH_LENGTH survivors; every live branch gets a
        finish_reason so the group sweeps out as a unit (group.sequences()
        ranks the finished pool)."""
        if survivors:
            for st in live:
                if not st.await_fork and not st.hold:
                    group.finished.append(SequenceResult(
                        tokens=list(st.generated), logprobs={},
                        cumulative_logprob=st.cum_logprob, finish_reason=FINISH_LENGTH,
                    ))
        for st in live:
            if st.finish_reason is None:
                st.finish_reason = FINISH_LENGTH
            st.hold = False

    # -- chunked prefill path ----------------------------------------------------
    def _admit_chunked(self, now: float) -> None:
        """Admit without computing: pages bind now (index registration deferred
        to publish_prefix), and the chunk cursor starts at the shared-prefix
        compute skip — the last whole-page boundary at or before the first
        token the adopted pages don't cover (>= 1 token is always computed)."""
        ps = self.cache.page_size
        for slot, state in self.scheduler.admit(self.queue, now, publish=False):
            if state.await_fork:
                continue  # a fresh sibling forks at its primary's first token
            n_ctx = len(state.context)
            skip = 0
            if self.config.prefill_compute_skip and self.cache.prefix_sharing:
                adopted = self.cache.adopted_pages(slot)
                skip = min(adopted * ps, ((n_ctx - 1) // ps) * ps)
            state.chunk_cursor = skip
            self.cache.set_len(slot, skip)
            self._c_pf_skipped.inc(skip)
            if self.trace is not None:
                self.trace.instant("admit", slot, rid=state.request.rid, context=n_ctx, skip=skip)

    def _prefill_chunks(self, now: float) -> None:
        """Advance PREFILLING slots by at most one chunk each within the step's
        token quota (decode appends are charged first). Chunks run
        shortest-remaining-first; each dispatches at the smallest power-of-two
        page-multiple bucket that holds it, zero-padded as a monolithic
        prefill pads, so chunk-written pages equal monolithic ones."""
        running = self.scheduler.running
        # chunk-cursor holders only (await_fork and beam-held slots have no
        # chunk); twin adopters wait until the donor's frontier covers them
        prefilling = [s for s in sorted(running)
                      if running[s].chunk_cursor is not None and self.cache.frontier_ready(s)]
        if not prefilling:
            return
        ps = self.cache.page_size
        n_decoding = sum(1 for st in running.values() if st.phase == DECODING)
        quota = self.config.step_token_quota or (self.config.max_batch + self._chunk_tokens)
        budget = max(0, quota - n_decoding)
        if n_decoding == 0:
            budget = max(budget, ps)  # liveness: chunks are the only progress
        prefilling.sort(
            key=lambda s: self.cache.pages_for(len(running[s].context)) * ps
            - running[s].chunk_cursor
        )
        dev = self.device
        for slot in prefilling:
            if budget < ps:
                break
            state = running[slot]
            ctx = state.context
            n_ctx = len(ctx)
            padded = self.cache.pages_for(n_ctx) * ps
            cursor = state.chunk_cursor
            c_real = min(self._chunk_tokens, padded - cursor, (budget // ps) * ps)
            budget -= c_real
            bucket = ps
            while bucket < c_real:
                bucket *= 2
            bucket = min(bucket, self._chunk_tokens)
            padded_ctx = list(ctx) + [0] * (padded - n_ctx)
            toks = padded_ctx[cursor:cursor + c_real] + [0] * (bucket - c_real)
            tr = self.trace
            if tr is not None:
                tr.begin("chunk", slot, rid=state.request.rid, cursor=cursor, tokens=c_real)
            t0 = time.perf_counter()
            logits, _ = self._chunk_step(
                self.params, self.cache.pools,
                torch.tensor([toks], dtype=torch.int32, device=dev),
                torch.from_numpy(self.cache.tables[slot:slot + 1].copy()).to(dev),
                torch.from_numpy(self.cache.write_table_row(slot)[None, :]).to(dev),
                torch.tensor([cursor], dtype=torch.int32, device=dev),
                torch.tensor([c_real], dtype=torch.int32, device=dev),
                torch.tensor([min(n_ctx - 1 - cursor, c_real - 1)], dtype=torch.int32,
                             device=dev),
            )
            done = cursor + c_real >= n_ctx  # this chunk covered the last position
            if done:
                self.cache.set_len(slot, n_ctx)
                state.chunk_cursor = None
                self.cache.publish_prefix(slot)
                self._first_token(state, logits[0])  # syncs: the chunk is timed whole
            else:
                if dev.type == "cuda":
                    torch.cuda.synchronize(dev)
                state.chunk_cursor = cursor + c_real
                self.cache.set_len(slot, cursor + c_real)
                # pages behind the new cursor are final: publish them
                self.cache.publish_prefix(slot, (cursor + c_real) // ps)
            self._h_chunk.observe(time.perf_counter() - t0)
            if tr is not None:
                tr.end("chunk", slot)
            self._c_pf_computed.inc(c_real)

    # -- decode path --------------------------------------------------------------
    def _sync_slot_state(self) -> None:
        """Re-upload the per-slot device vectors only when slot composition
        changed (admission, finish, preemption, a prefill completing)."""
        running = self.scheduler.running
        sig = tuple((slot, st.request.rid, st.phase) for slot, st in sorted(running.items()))
        if not self._slots_stale and sig == self._slot_sig:
            return
        b = self.config.max_batch
        tokens = np.zeros((b,), np.int32)
        active = np.zeros((1, b), np.int32)
        decoding = {}
        for slot, state in running.items():
            if state.phase == DECODING:
                tokens[slot] = state.generated[-1]
                active[0, slot] = 1
                decoding[slot] = state
        f32p, i32p = pack_slot_params(decoding, b)
        self._tokens_dev = torch.from_numpy(tokens).to(self.device)
        self._slot_f32 = torch.from_numpy(f32p).to(self.device)
        self._slot_i32 = torch.from_numpy(np.vstack([active, i32p])).to(self.device)
        self._any_sampled = any(st.sampling.temperature > 0 for st in decoding.values())
        if self._grammar_on:
            # the slots' grammar states re-seed from the host mirror on the
            # same trigger; otherwise the step's output flows back
            gstate = np.zeros((b,), np.int32)
            for slot, state in decoding.items():
                if state.grammar_state is not None:
                    gstate[slot] = state.grammar_state
            self._gstate_dev = torch.from_numpy(gstate).to(self.device)
        self._slots_stale = False
        self._slot_sig = sig

    def _fused_k(self, now: float) -> int:
        """How many decode steps one dispatch runs: K when the scheduler
        proves the horizon event-free and no pending arrival lands inside it
        (estimated from the last measured step), else 1. A short horizon first
        pre-appends decode pages up to the window
        (Scheduler.reserve_decode_tokens) and re-proves."""
        if self._k <= 1:
            return 1
        if self.scheduler.event_free_horizon(self.queue) < self._k:
            if self.queue:
                return 1
            for slot, st in self.scheduler.running.items():
                if st.phase == DECODING:
                    self.scheduler.reserve_decode_tokens(slot, self._k)
            if self.scheduler.event_free_horizon(self.queue) < self._k:
                return 1
        if self._pending:
            est = self._last_step_time if self._last_step_time else 2e-3
            if self._pending[0].request.arrival_time <= now + self._k * est:
                return 1
        return self._k

    # -- speculative path (serving/speculative.py) --------------------------------
    def _spec_plan(self, now: float, decoding) -> int:
        """Windows to run speculatively in this dispatch (0 = plain decode).
        Speculation is batch-wide: every decoding slot must be eligible (no
        per-request opt-out, no grammar, no branch group), the window's page budget (S * (K + 1) tokens a
        slot) must pre-reserve, the horizon must prove S windows event-free
        at tokens_per_step = K + 1, and no pending arrival may land inside
        the window. Any failure degrades to plain decode for this dispatch.

        Adaptive backoff: while the acceptance EMA sits under
        spec_accept_floor, the planner answers 0 for a backoff of plain
        dispatches before probing another window."""
        if not decoding or self.queue:
            return 0
        if self._spec_backoff_left:
            self._spec_backoff_left -= 1
            return 0
        for state in decoding.values():
            p = state.request.params
            if p.speculative is False or p.grammar is not None or state.group is not None:
                return 0
        c = self._spec_k + 1
        s = self._spec_windows
        for slot in decoding:
            if not self.scheduler.reserve_decode_tokens(slot, s * c):
                return 0
        if self.scheduler.event_free_horizon(self.queue, tokens_per_step=c) < s:
            return 0
        if self._pending:
            est = self._last_step_time if self._last_step_time else 2e-3
            if self._pending[0].request.arrival_time <= now + s * est:
                return 0
        return s

    def _sync_spec_state(self, decoding) -> None:
        """Rebuild the proposer's hist / table rows of slots whose context
        changed outside a speculative window (admission, plain steps,
        preemption-recompute): the speculative twin of _sync_slot_state. A
        rebuilt row equals what the window's device updates would have made
        (NGramProposer's insertion law), so plain and speculative dispatches
        mix without drift."""
        stale = sorted(s for s in self._spec_stale if s in decoding)
        if stale:
            rows = [self._proposer.rebuild_row(decoding[slot].context) for slot in stale]
            idx = torch.tensor(stale, dtype=torch.long, device=self.device)
            self._hist_dev.index_copy_(
                0, idx, torch.from_numpy(np.stack([h for h, _ in rows])).to(self.device))
            self._table_dev.index_copy_(
                0, idx, torch.from_numpy(np.stack([t for _, t in rows])).to(self.device))
        self._spec_stale.difference_update(stale)

    def _observe_dispatch(self, t_dev: float, n: int) -> None:
        """Record a dispatch of ``n`` steps (or windows) that took ``t_dev``:
        n step-time entries of t_dev / n, the straggler verdict on one."""
        per = t_dev / n
        for _ in range(n):
            self._h_step.observe(per)
        self._last_step_time = per
        self._c_decode.inc(n)
        verdict = self._straggler.observe(per)
        if verdict != "ok":
            self._c_slow.inc()
            if self.trace is not None:
                self.trace.instant("slow_step", -1, verdict=verdict, step_ms=per * 1e3,
                                   ema_ms=(self._straggler.ema or 0.0) * 1e3)

    def _decode_spec_once(self, decoding, s: int) -> None:
        """One speculative dispatch: S windows of propose -> verify -> accept
        with no device-to-host transfer between them. Each window commits 1 ..
        K + 1 tokens a slot; the rejected suffix is never covered by the
        advanced lens (its KV sits in pre-reserved owned pages, and later
        appends overwrite it). The only bulk transfer is one packed fetch of
        the (S, B, K + 1) ids, the committed counts and the log-probs."""
        wall0 = time.perf_counter()
        self._sync_slot_state()
        self._sync_spec_state(decoding)
        tables, lens = self.cache.device_state()
        kd = self._spec_k
        c = kd + 1
        tr = self.trace
        if tr is not None:
            tr.begin("spec_window", -1, windows=s, k=kd, batch=len(decoding))
        want_lp = self._lp_k and any(st.request.logprobs for st in decoding.values())
        t0 = time.perf_counter()
        out = self._spec_step(
            self.params, self.cache.pools, self._tokens_dev, tables, lens, self._slot_f32,
            self._slot_i32, self._hist_dev, self._table_dev, sampled=self._any_sampled,
        )
        toks, committed, last, new_lens, _, lps, hist, table = out[:8]
        got = _fetch(toks, committed, lps, *(out[8] if want_lp else ()))
        ids, acc, lp_arr = got[:3]  # (S, B, C), (S, B), (S, B, C)
        lp_vals, lp_ids = got[3:] if want_lp else (None, None)  # (S, B, C, k)
        t_dev = time.perf_counter() - t0
        self.cache.adopt_lens_device(new_lens)
        self._tokens_dev = last
        self._hist_dev, self._table_dev = hist, table
        self._c_fused.inc(s)
        self._observe_dispatch(t_dev, s)  # one window = one model dispatch, as a step
        win_acc = win_n = 0
        for i in range(s):
            for slot, state in decoding.items():
                if state.done:
                    continue  # finished mid-dispatch: its later windows are discarded
                a = int(acc[i, slot])
                take = 0
                for j in range(a):
                    state.generated.append(int(ids[i, slot, j]))
                    state.cum_logprob += float(lp_arr[i, slot, j])
                    take += 1
                    n_lp = state.request.logprobs
                    if n_lp and lp_vals is not None:
                        state.logprobs[len(state.generated) - 1] = _top_pairs(
                            lp_vals[i, slot, j], lp_ids[i, slot, j], n_lp)
                    if state.done:
                        break  # EOS or the length cap inside the window
                # the host mirror follows the honest count; a truncated slot
                # is done and sweeps out, and free_slot marks its device row
                # dirty, repairing the lens the window over-advanced
                self.cache.bump_len(slot, take)
                win_n += 1
                win_acc += take
                self._c_spec_windows.inc()
                self._c_spec_accepted.inc(take)
                # draft hits: committed tokens that came from the draft (the
                # last committed one is the target's correction or bonus)
                self._c_spec_hits.inc(min(take, max(a - 1, 0)))
                self._c_spec_rollback.inc(c - a)
        mean = win_acc / win_n if win_n else 0.0
        ema = self._spec_accept_ema
        self._spec_accept_ema = mean if ema is None else 0.6 * ema + 0.4 * mean
        if self.config.spec_backoff:
            if self._spec_accept_ema < self.config.spec_accept_floor:
                self._spec_backoff_left = self._spec_backoff_len
                self._spec_backoff_len = min(self._spec_backoff_len * 2,
                                             32 * self.config.spec_backoff)
                self._c_spec_backoffs.inc()
                if tr is not None:
                    tr.instant("spec_backoff", -1, ema=self._spec_accept_ema,
                               floor=self.config.spec_accept_floor,
                               dispatches=self._spec_backoff_left)
            else:
                self._spec_backoff_len = int(self.config.spec_backoff)
        if tr is not None:
            tr.instant("spec_accept", -1, windows=win_n, accepted=win_acc, mean=mean)
            tr.end("spec_window", -1)
        self._h_host.observe((time.perf_counter() - wall0 - t_dev) / s)

    def _decode_once(self) -> None:
        """One device dispatch of the decode hot path: a speculative dispatch
        (``spec_tokens``), a fused K-step window over an event-free horizon,
        or a single fused step. PREFILLING and empty slots are masked on the
        device by the phase bitmap. Tokens are sampled on the device; the
        only device-to-host traffic is one packed fetch a dispatch."""
        now = time.perf_counter() - self._t0
        running = self.scheduler.running
        decoding = {s: st for s, st in running.items() if st.phase == DECODING}
        if self._spec_k:
            n_win = self._spec_plan(now, decoding)
            if n_win:
                self._decode_spec_once(decoding, n_win)
                return
            # plain decode makes tokens the proposer's device rows never saw
            self._spec_stale.update(decoding)
        wall0 = time.perf_counter()
        k = self._fused_k(now)
        self._sync_slot_state()
        tables, lens = self.cache.device_state()
        tr = self.trace
        span = "fused_window" if k > 1 else "decode"
        if tr is not None:
            tr.begin(span, -1, k=k, batch=len(decoding))
        # the top-k pair is computed whenever logprobs_k > 0 but fetched only
        # when a decoding request asked for it, or a beam group rides it (the
        # pair is its candidate set)
        want_lp = self._lp_k and any(
            st.request.logprobs or (st.group is not None and st.group.mode == "beam")
            for st in decoding.values())
        g_args = ((self._gstate_dev, self._gmask_dev, self._gtrans_dev)
                  if self._grammar_on else ())
        lp_i = 6 if self._grammar_on else 5  # the top-k pair's output index
        t0 = time.perf_counter()
        if k > 1:
            out = self._multistep(
                self.params, self.cache.pools, self._tokens_dev, tables, lens,
                self._slot_f32, self._slot_i32, *g_args, sampled=self._any_sampled,
            )
            toks, last, new_lens, _, lps = out[:5]
            top = out[lp_i] if want_lp else ()
            self._c_fused.inc(k)
        else:
            out = self._step(
                self.params, self.cache.pools, self._tokens_dev, tables, lens,
                self._slot_f32, self._slot_i32, *g_args, sampled=self._any_sampled,
            )
            last, _, new_lens, _, lps = out[:5]
            toks, lps = last[None], lps[None]  # (1, B)
            top = tuple(t[None] for t in out[lp_i]) if want_lp else ()
        if self._grammar_on:
            self._gstate_dev = out[5]
        # recording (K = 1) adds the (B, vocab) logits rows to the fetch
        record = any(self._records(st) for st in decoding.values())
        rows = (out[1][:, :self._vocab],) if record else ()
        # the dispatch's only device-to-host copy
        got = _fetch(toks, lps, *top, *rows)
        ids, lp_arr = got[:2]  # (K, B)
        lp_vals, lp_ids = got[2:4] if want_lp else (None, None)  # (K, B, k)
        logits_rows = got[-1] if record else None  # (B, vocab)
        t_dev = time.perf_counter() - t0
        self.cache.adopt_lens_device(new_lens)
        self._tokens_dev = last
        self._observe_dispatch(t_dev, k)
        beam_groups = []
        for i in range(k):
            for slot, state in decoding.items():
                if state.done:
                    continue  # finished mid-window (EOS): the overrun ids are discarded
                grp = state.group
                if grp is not None and grp.mode == "beam":
                    # the KV write happened, but the device's sample is not
                    # the branch's next token: its top-k row is a candidate
                    # row of the joint selection
                    self.cache.bump_len(slot)
                    grp.pending_rows[state.branch] = (lp_vals[i, slot], lp_ids[i, slot])
                    if grp not in beam_groups:
                        beam_groups.append(grp)
                    continue
                tok = int(ids[i, slot])
                state.generated.append(tok)
                state.cum_logprob += float(lp_arr[i, slot])
                if state.grammar_state is not None:
                    state.grammar_state = int(self._gtrans_host[state.grammar_state, tok])
                self.cache.bump_len(slot)
                n_lp = state.request.logprobs
                if n_lp and lp_vals is not None:
                    state.logprobs[len(state.generated) - 1] = _top_pairs(
                        lp_vals[i, slot], lp_ids[i, slot], n_lp)
                if logits_rows is not None and self._records(state):
                    self.logits_of.setdefault(state.request.rid, {})[
                        len(state.generated) - 1] = logits_rows[slot].copy()
        for grp in beam_groups:
            started = [st for st in grp.branches if not st.await_fork and not st.done]
            if all(st.branch in grp.pending_rows for st in started):
                self._beam_advance(grp)
        if tr is not None:
            tr.end(span, -1)
        self._h_host.observe((time.perf_counter() - wall0 - t_dev) / k)

    def _sweep_finished(self) -> None:
        for slot in list(self.scheduler.running):
            state = self.scheduler.running[slot]
            if state.done:
                state.finish_time = time.perf_counter() - self._t0
                reason = state.finished_reason()
                if self.trace is not None:
                    self.trace.instant("finish", slot, rid=state.request.rid, reason=reason,
                                       generated=len(state.generated), branch=state.branch)
                # session retention: a cleanly finished request's complete
                # pages go to the host tier with a deadline, so a follow-up
                # sharing its context prefetches instead of re-prefilling
                if (self.cache.tier is not None and self.config.retain_finished_s > 0
                        and state.error is None):
                    self.cache.demote_slot(slot, state.hash_chain(self.cache.page_size),
                                           retain_s=self.config.retain_finished_s)
                # freeing a branch decrefs, never frees, the pages its running
                # siblings alias, so one branch's EOS does not disturb the rest
                self.scheduler.finish(slot)
                grp = state.group
                if grp is None:
                    self.results[state.request.rid] = state
                elif grp.all_done and state.request.rid not in self.results:
                    # the group completes as a unit: results carry the
                    # primary, whose .sequences collects every branch
                    grp.primary.finish_time = state.finish_time
                    self.results[state.request.rid] = grp.primary

    # -- main loop ----------------------------------------------------------------
    def run(self, requests: Optional[Sequence[Request]] = None) -> Dict[int, RequestState]:
        """Serve until every submitted request completes; returns rid -> state.
        A request the pool can never hold is FAILED (``.error`` set) instead of
        wedging the queue."""
        if requests is not None:
            self.submit_all(requests)
        self._pending.sort(key=lambda s: s.request.arrival_time)
        chunked = self.config.chunked_prefill
        self._t0 = time.perf_counter()
        while self._pending or self.queue or self.scheduler.running:
            now = time.perf_counter() - self._t0
            if self.cache.tier is not None:
                self.cache.tier.begin_step()
            # a twin whose donor died before writing its adopted pages holds
            # garbage there: back to the queue for a clean re-admit
            for slot in self.cache.take_broken():
                self.scheduler.preempt_slot(slot, self.queue)
            while self._pending and self._pending[0].request.arrival_time <= now:
                state = self._pending.pop(0)
                if self.trace is not None:
                    self.trace.instant("enqueue", rid=state.request.rid)
                self.queue.push(state)
            for state in self.scheduler.reject_impossible(self.queue):
                state.finish_time = time.perf_counter() - self._t0
                # a rejected request can never resume: drop its host residency
                self.cache.release_host(state.hash_chain(self.cache.page_size))
                if state.group is not None:
                    for st in state.group.branches:
                        if st.finish_reason is None:  # earlier finishes stay
                            st.error = state.error
                            st.finish_reason = FINISH_ERROR
                else:
                    state.finish_reason = FINISH_ERROR
                self.results[state.request.rid] = state
            if chunked:
                self._admit_chunked(now)
                self._prefill_chunks(now)
            else:
                self._admit_and_prefill(now)
            self._sweep_finished()  # a request can complete at prefill time
            running = self.scheduler.running
            if any(st.phase == DECODING for st in running.values()):
                for slot in sorted(running):
                    if slot in running and running[slot].phase == DECODING:
                        self.scheduler.ensure_decode_page(slot, self.queue)
                self._decode_once()
                self._sweep_finished()
            elif running:
                pass  # only PREFILLING slots: the next mixed step keeps chunking
            elif self._pending and not self.queue:
                time.sleep(min(max(self._pending[0].request.arrival_time - now, 0.0), 0.01))
            elif self.queue:
                head = self.queue.peek()
                raise RuntimeError(
                    f"request {head.request.rid} needs "
                    f"{self.cache.new_pages_needed(head.context)} new pages but only "
                    f"{self.cache.num_free} exist — raise num_pages"
                )
        return self.results

    def reset_metrics(self) -> None:
        """Drop finished-request records and timing state (a warm-up run on the
        same engine, then a measured one)."""
        self.results = {}
        self.logits_of = {}
        self.registry.reset()
        if self.trace is not None:
            self.trace.clear()
        self._last_step_time = None
        self._straggler = StragglerPolicy(threshold=self.config.slow_step_threshold)
        self.cache.reset_stats()

    # -- metrics ------------------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        """Flat snapshot over the registry, the per-request records and the
        allocator stats (histogram percentiles within one log bucket, ~7.5%)."""
        # the autotuner's decision rides every snapshot, empty ones included;
        # without autotune the snapshot keeps its shape
        tuning: Dict[str, object] = {}
        if self.tuned is not None:
            tuning = {
                "tuned_page_size": self.config.page_size,
                "tuned_block_pages": self.config.decode_block_pages,
                "tuned_chunk_tokens": self.config.chunk_tokens,
                "tuned_source": self.tuned.source,
            }
        failed = [s for s in self.results.values() if s.error is not None]
        states = [s for s in self.results.values() if s.error is None]
        if not states:
            out = {"failed": len(failed)} if failed else {}
            out.update(tuning)
            return out
        wall = max(s.finish_time for s in states)
        span = wall - min(s.request.arrival_time for s in states)
        e2e = np.array([s.finish_time - s.request.arrival_time for s in states])
        ttft = np.array([s.first_token_time - s.request.arrival_time for s in states])
        # a group's primary stands for the whole group: count every branch
        n_tok = sum(sum(len(b.generated) for b in s.group.branches) if s.group is not None
                    else len(s.generated) for s in states)
        # speculative telemetry, absent when spec_tokens=0 (the plain snapshot
        # keeps its shape): accepted_tokens_per_step is the mean tokens
        # committed a slot-window (>= 1: the correction token always commits),
        # draft_hit_rate the share of proposed draft tokens that committed,
        # spec_rollback_tokens the positions written then rolled back
        spec: Dict[str, float] = {}
        if self._spec_k:
            w = self._c_spec_windows.value
            spec = {
                "spec_windows": w,
                "spec_accepted_tokens": self._c_spec_accepted.value,
                "accepted_tokens_per_step": self._c_spec_accepted.value / w if w else 0.0,
                "draft_hit_rate": self._c_spec_hits.value / (w * self._spec_k) if w else 0.0,
                "spec_rollback_tokens": self._c_spec_rollback.value,
                "spec_backoffs": self._c_spec_backoffs.value,
            }
        return {
            "requests": len(states),
            "failed": len(failed),
            "generated_tokens": n_tok,
            "wall_s": float(wall),
            "tokens_per_s": float(n_tok / span) if span > 0 else float("inf"),
            "decode_steps": self._c_decode.value,
            "fused_steps": self._c_fused.value,
            "step_ms_p50": self._h_step.percentile(50) * 1e3,
            "step_ms_p95": self._h_step.percentile(95) * 1e3,
            "decode_ms_total": self._h_step.total * 1e3,
            "host_overhead_ms_p50": self._h_host.percentile(50) * 1e3,
            "chunk_ms_p50": self._h_chunk.percentile(50) * 1e3,
            "latency_s_p50": float(np.percentile(e2e, 50)),
            "latency_s_p99": float(np.percentile(e2e, 99)),
            "ttft_s_p50": float(np.percentile(ttft, 50)),
            "ttft_s_p95": float(np.percentile(ttft, 95)),
            "ttft_s_p99": float(np.percentile(ttft, 99)),
            "preemptions": sum(s.n_preemptions for s in states),
            "slow_steps": self._c_slow.value,
            "prefill_tokens_computed": self._c_pf_computed.value,
            "prefill_tokens_skipped": self._c_pf_skipped.value,
            **spec,
            **self.cache.stats(),
            **tuning,
        }
