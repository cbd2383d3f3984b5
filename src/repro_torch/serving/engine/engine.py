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
per-token device-to-host traffic is one packed (2, B) fetch of the sampled
ids and their log-probabilities.

Quantization composes with all of it: ``kv_dtype`` "int8" / "int4" stores the
pages as intN bytes with per-(page, head) scales (kvquant.PagedQuantSpec), and
a model built with ``build_model(cfg, quantized=True)`` runs its MLP on int8
weights; the allocator, the prefix index and CoW never look at the bytes.

Not ported yet (refused by EngineConfig, naming the ROADMAP item):
speculative decoding, the host page tier, multi-step fused decode,
grammar-constrained decoding, beam search, top-k logprobs, autotuning and
logits recording.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.kernels.common import resolve_device
from repro_torch.runtime.health import StragglerPolicy
from repro_torch.serving.params import FINISH_ERROR, GenerationParams, RequestHandle
from repro_torch.serving.sampling import pack_slot_params, stream_seed
from repro_torch.serving.step import (
    make_chunked_prefill_step,
    make_paged_serve_step,
    make_prefill,
)
from repro_torch.serving.telemetry import EngineTrace, MetricsRegistry

from .cache import PagedKVCache
from .request import DECODING, Request, RequestQueue, RequestState
from .scheduler import Scheduler, SchedulerConfig

# EngineConfig fields whose features wait for a later slice: field -> (value
# that means "off", the ROADMAP Queue 1 item that ports it)
_NOT_PORTED = {
    "spec_tokens": (0, "item 2 (speculative decoding)"),
    "host_pool_pages": (0, "item 2 (the host KV tier)"),
    "multi_step": (1, "item 2 (multi-step fused decode as a CUDA graph)"),
    "grammar_states": (0, "item 2 (constrained decoding)"),
    "max_beam_width": (0, "item 2 (beam search)"),
    "logprobs_k": (0, "item 2 (top-k logprobs)"),
    "autotune": (False, "item 7 (perf tooling and autotuning)"),
    "record_logits": (False, "item 7 (perf tooling)"),
}


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    num_pages: int = 64
    page_size: int = 16
    max_batch: int = 8
    max_pages_per_seq: int = 16
    watermark_pages: int = 1
    prefix_sharing: bool = True
    chunked_prefill: bool = False
    chunk_tokens: int = 0  # max tokens per prefill chunk (page multiple; 0 = 2 pages)
    step_token_quota: int = 0  # per-step token budget (0 = max_batch + chunk_tokens)
    prefill_compute_skip: bool = True  # chunked + sharing: skip adopted pages' compute
    trace: bool = False  # record lifecycle events (serving.telemetry.EngineTrace)
    trace_capacity: int = 65536
    slow_step_threshold: float = 2.0  # StragglerPolicy threshold on decode steps
    kv_dtype: str = "f32"  # "f32" | "int8" | "int4": the KV page representation
    # not ported yet: any value other than "off" raises (see _NOT_PORTED)
    spec_tokens: int = 0
    host_pool_pages: int = 0
    multi_step: int = 1
    grammar_states: int = 0
    max_beam_width: int = 0
    logprobs_k: int = 0
    autotune: bool = False
    record_logits: bool = False

    def __post_init__(self):
        for name, (off, item) in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"EngineConfig.{name}={getattr(self, name)!r} is not ported yet: "
                    f"ROADMAP Queue 1 {item}"
                )

    @classmethod
    def sized_for(cls, max_len: int, *, page_size: int, max_batch: int, **kw) -> "EngineConfig":
        """Pool sized so max_batch sequences of ``max_len`` tokens run with no
        contention (+1 decode-headroom page each, + the null page)."""
        pages_per_seq = -(-max_len // page_size) + 1
        return cls(
            num_pages=max_batch * pages_per_seq + 1, page_size=page_size,
            max_batch=max_batch, max_pages_per_seq=pages_per_seq, **kw,
        )


def _fetch_ids_lp(ids: torch.Tensor, lp: torch.Tensor):
    """One device-to-host copy of (ids int32, log-probs f32), packed as int32
    bits; returns two numpy arrays."""
    packed = torch.stack([ids.to(torch.int32), lp.float().view(torch.int32)]).cpu().numpy()
    return packed[0], packed[1].view(np.float32)


class ServeEngine:
    def __init__(self, model, params, config: EngineConfig = EngineConfig(), device=None):
        self.device = resolve_device(device)
        if model.device != self.device:
            raise ValueError(f"model lives on {model.device}, engine asked for {self.device}")
        self.model = model
        self.params = params
        self.config = config
        self.cache = PagedKVCache(
            model, num_pages=config.num_pages, page_size=config.page_size,
            max_batch=config.max_batch, max_pages_per_seq=config.max_pages_per_seq,
            prefix_sharing=config.prefix_sharing, kv_dtype=config.kv_dtype,
        )
        self.scheduler = Scheduler(
            self.cache, SchedulerConfig(config.max_batch, config.watermark_pages)
        )
        self.queue = RequestQueue()
        self._pending: List[RequestState] = []  # submitted, not yet arrived
        self.trace = EngineTrace(config.trace_capacity) if config.trace else None
        self.cache.trace = self.trace
        self.scheduler.trace = self.trace
        self.registry = MetricsRegistry()
        self._h_step = self.registry.histogram("step_time_s")
        self._h_host = self.registry.histogram("host_overhead_s")
        self._h_chunk = self.registry.histogram("chunk_time_s")
        self._c_decode = self.registry.counter("decode_steps")
        self._c_pf_computed = self.registry.counter("prefill_tokens_computed")
        self._c_pf_skipped = self.registry.counter("prefill_tokens_skipped")
        self._c_slow = self.registry.counter("slow_steps")
        self._straggler = StragglerPolicy(threshold=config.slow_step_threshold)
        self._vocab = model.cfg.vocab
        self._step = make_paged_serve_step(model, self.cache.kv_spec)
        self._prefill = make_prefill(model)
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
            self._chunk_step = make_chunked_prefill_step(model, self.cache.kv_spec)
        self.results: Dict[int, RequestState] = {}
        self._next_rid = 0
        self._t0 = time.perf_counter()

    # -- submission -------------------------------------------------------------
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
        if p.logprobs:
            raise ValueError(
                f"request {request.rid} asks for {p.logprobs} logprobs but the engine "
                f"computes none (EngineConfig.logprobs_k is not ported yet)"
            )
        if p.record_logits:
            raise ValueError(f"request {request.rid} asks for record_logits; not ported yet")
        need = self.cache.pages_for(len(request.prompt) + p.max_new_tokens)
        if need > self.config.max_pages_per_seq:
            raise ValueError(
                f"request {request.rid} will need {need} pages "
                f"(prompt {len(request.prompt)} + up to {p.max_new_tokens} new) "
                f"> max_pages_per_seq {self.config.max_pages_per_seq}"
            )
        floor = self.cache.pages_for(len(request.prompt) + 1)
        if floor > self.config.num_pages - 1:
            raise ValueError(
                f"request {request.rid} needs {floor} pages just to admit its "
                f"{len(request.prompt)}-token prompt, but the pool only has "
                f"{self.config.num_pages - 1} usable pages — raise num_pages"
            )
        self._pending.append(RequestState(request))
        return RequestHandle(self, request.rid)

    def submit_all(self, requests: Sequence[Request]) -> List[RequestHandle]:
        return [self.submit(r) for r in requests]

    # -- prefill path -----------------------------------------------------------
    def _admit_and_prefill(self, now: float) -> None:
        tr = self.trace
        for slot, state in self.scheduler.admit(self.queue, now):
            ctx = state.context
            padded = self.cache.pages_for(len(ctx)) * self.cache.page_size
            if tr is not None:
                tr.instant("admit", slot, rid=state.request.rid, context=len(ctx))
                tr.begin("prefill", slot, rid=state.request.rid, tokens=padded)
            # right-pad to the page bucket; logits read at the true last position
            tokens = torch.tensor([list(ctx) + [0] * (padded - len(ctx))], dtype=torch.int32,
                                  device=self.device)
            logits, caches = self._prefill(self.params, tokens, last_index=len(ctx) - 1)
            self.cache.write_prefill(slot, caches)
            self.cache.set_len(slot, len(ctx))
            self._c_pf_computed.inc(padded)
            if tr is not None:
                tr.end("prefill", slot)
            self._first_token(state, logits[0, 0])

    def _first_token(self, state: RequestState, logits_row: torch.Tensor) -> None:
        """Sample the token a completed prefill produced, on the device; only
        the id and its log-probability cross to the host. The sampled position
        is len(context), as the decode path would use for the same token."""
        sp = state.sampling
        seed_bits = np.uint32(stream_seed(sp.seed, state.request.rid)).astype(np.int32)
        f = torch.tensor([sp.temperature, sp.top_p], dtype=torch.float32, device=self.device)
        i = torch.tensor([sp.top_k, int(seed_bits), len(state.context)], dtype=torch.int32,
                         device=self.device)
        tok = ops.sample_tokens(
            logits_row[None], f[0:1], i[0:1], f[1:2], i[1:2], i[2:3], vocab=self._vocab,
            sampled=sp.temperature > 0,
        )
        lp = torch.log_softmax(logits_row[:self._vocab].float(), dim=-1)[tok.long()]
        ids, lps = _fetch_ids_lp(tok, lp)
        state.generated.append(int(ids[0]))
        state.cum_logprob += float(lps[0])
        self._slots_stale = True  # the slot's next decode input is host-known
        if state.first_token_time is None:
            state.first_token_time = time.perf_counter() - self._t0

    # -- chunked prefill path ----------------------------------------------------
    def _admit_chunked(self, now: float) -> None:
        """Admit without computing: pages bind now (index registration deferred
        to publish_prefix), and the chunk cursor starts at the shared-prefix
        compute skip — the last whole-page boundary at or before the first
        token the adopted pages don't cover (>= 1 token is always computed)."""
        ps = self.cache.page_size
        for slot, state in self.scheduler.admit(self.queue, now, publish=False):
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
        # twin adopters wait until the donor's written frontier covers them
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
        self._slots_stale = False
        self._slot_sig = sig

    def _decode_once(self) -> None:
        """One fused decode step over every slot; PREFILLING and empty slots
        are masked on the device by the phase bitmap."""
        running = self.scheduler.running
        decoding = {s: st for s, st in running.items() if st.phase == DECODING}
        wall0 = time.perf_counter()
        self._sync_slot_state()
        tables, lens = self.cache.device_state()
        tr = self.trace
        if tr is not None:
            tr.begin("decode", -1, k=1, batch=len(decoding))
        t0 = time.perf_counter()
        nxt, _, new_lens, _, lp = self._step(
            self.params, self.cache.pools, self._tokens_dev, tables, lens,
            self._slot_f32, self._slot_i32, sampled=self._any_sampled,
        )
        ids, lps = _fetch_ids_lp(nxt, lp)  # the step's only device-to-host copy
        t_dev = time.perf_counter() - t0
        self.cache.adopt_lens_device(new_lens)
        self._tokens_dev = nxt
        self._h_step.observe(t_dev)
        self._c_decode.inc()
        verdict = self._straggler.observe(t_dev)
        if verdict != "ok":
            self._c_slow.inc()
            if tr is not None:
                tr.instant("slow_step", -1, verdict=verdict, step_ms=t_dev * 1e3,
                           ema_ms=(self._straggler.ema or 0.0) * 1e3)
        for slot, state in decoding.items():
            state.generated.append(int(ids[slot]))
            state.cum_logprob += float(lps[slot])
            self.cache.bump_len(slot)
        if tr is not None:
            tr.end("decode", -1)
        self._h_host.observe(time.perf_counter() - wall0 - t_dev)

    def _sweep_finished(self) -> None:
        for slot in list(self.scheduler.running):
            state = self.scheduler.running[slot]
            if state.done:
                state.finish_time = time.perf_counter() - self._t0
                reason = state.finished_reason()
                if self.trace is not None:
                    self.trace.instant("finish", slot, rid=state.request.rid, reason=reason,
                                       generated=len(state.generated))
                self.scheduler.finish(slot)
                self.results[state.request.rid] = state

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
        self.registry.reset()
        if self.trace is not None:
            self.trace.clear()
        self._straggler = StragglerPolicy(threshold=self.config.slow_step_threshold)
        self.cache.reset_stats()

    # -- metrics ------------------------------------------------------------------
    def metrics(self) -> Dict[str, float]:
        """Flat snapshot over the registry, the per-request records and the
        allocator stats (histogram percentiles within one log bucket, ~7.5%)."""
        failed = [s for s in self.results.values() if s.error is not None]
        states = [s for s in self.results.values() if s.error is None]
        if not states:
            return {"failed": len(failed)} if failed else {}
        wall = max(s.finish_time for s in states)
        span = wall - min(s.request.arrival_time for s in states)
        e2e = np.array([s.finish_time - s.request.arrival_time for s in states])
        ttft = np.array([s.first_token_time - s.request.arrival_time for s in states])
        n_tok = sum(len(s.generated) for s in states)
        return {
            "requests": len(states),
            "failed": len(failed),
            "generated_tokens": n_tok,
            "wall_s": float(wall),
            "tokens_per_s": float(n_tok / span) if span > 0 else float("inf"),
            "decode_steps": self._c_decode.value,
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
            **self.cache.stats(),
        }
