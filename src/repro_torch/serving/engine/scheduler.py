"""Step-level admission/eviction policy for the continuous-batching engine.

Port of ``repro.serving.engine.scheduler``. Each engine step the scheduler:
  1. admits queued requests FIFO while a batch slot is free AND the pool can
     hold the whole context plus a one-page decode headroom (watermark);
     pages a request can adopt from the prefix index cost nothing. A branch
     group admits as a unit: one slot a live branch, or none;
  2. guarantees every running sequence a page it may WRITE for its next token
     (append at page boundaries, copy-on-write a shared target page),
     preempting the most recently admitted other sequence (its whole group)
     when the pool runs dry. The victim releases its pages and requeues at
     the front with its generated tokens kept; with a host tier its complete
     pages demote to host RAM first, so re-admission promotes them back and
     recomputes only the tail.

For the fused decode window and the speculative window it also proves an
event-free horizon (``event_free_horizon``) and pre-appends the pages a
window will write (``reserve_decode_tokens``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from .cache import PagedKVCache
from .request import DECODING, BranchGroup, RequestQueue, RequestState


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    max_batch: int
    watermark_pages: int = 1  # free pages kept back at admission for decode growth


class Scheduler:
    def __init__(self, cache: PagedKVCache, config: SchedulerConfig):
        self.cache = cache
        self.config = config
        self.running: Dict[int, RequestState] = {}  # slot -> state, admission order
        self.trace = None  # serving.telemetry.EngineTrace, attached by the engine

    def _chain_of(self, state: RequestState):
        if not self.cache.prefix_sharing:
            return None
        return state.hash_chain(self.cache.page_size)

    def free_slots(self) -> List[int]:
        return [s for s in range(self.config.max_batch) if s not in self.running]

    def fits(self, state: RequestState) -> bool:
        need = self.cache.new_pages_needed(state.context, chain=self._chain_of(state))
        # no watermark with an empty batch: nothing to collide with, and an
        # unadmittable head with nothing running would deadlock
        watermark = self.config.watermark_pages if self.running else 0
        return need + watermark <= self.cache.num_free

    def _group_need(self, group: BranchGroup) -> int:
        """Free-list pages a whole branch group needs at admission: a fresh
        sibling forks the primary's pages and costs at most one fresh page
        (the decode headroom of an aligned prompt, or the later CoW of a
        shared partial page, never both); a re-admitted sibling re-prefills
        its own context and is costed like any request."""
        need = 0
        for st in group.branches:
            if st.done:
                continue
            if st.await_fork:
                need += 1
            else:
                need += self.cache.new_pages_needed(st.context, chain=self._chain_of(st))
        return need

    def impossible(self, state: RequestState) -> bool:
        """True when the context needs more pages than the whole pool holds."""
        return self.cache.pages_for(len(state.context) + 1) > self.cache.num_pages - 1

    def reject_impossible(self, queue: RequestQueue) -> List[RequestState]:
        """Pop every queue-head request impossible() condemns, stamping .error."""
        failed = []
        while queue:
            state = queue.peek()
            if not self.impossible(state):
                break
            queue.pop()
            state.error = (
                f"request {state.request.rid} needs "
                f"{self.cache.pages_for(len(state.context) + 1)} pages for its "
                f"{len(state.context)}-token context but the pool only has "
                f"{self.cache.num_pages - 1} — raise num_pages or shorten the request"
            )
            if self.trace is not None:
                self.trace.instant("reject", rid=state.request.rid, context=len(state.context))
            failed.append(state)
        return failed

    def admit(self, queue: RequestQueue, now: float,
              publish: bool = True) -> List[Tuple[int, RequestState]]:
        """Pop admissible requests, allocate their context pages (+1 headroom
        so the first decode token has a slot), bind batch slots."""
        admitted = []
        slots = self.free_slots()
        while queue and slots:
            state = queue.peek()
            if state.request.arrival_time > now:
                break
            group = state.group
            if group is not None:
                # a group admits AS A UNIT (a partial group would let a
                # sibling's admission preempt its own primary)
                live = [st for st in group.branches if not st.done]
                if len(slots) < len(live):
                    break
                watermark = self.config.watermark_pages if self.running else 0
                if self._group_need(group) + watermark > self.cache.num_free:
                    # _group_need costs every re-prefilling branch's context
                    # as its own, though the branches adopt each other's
                    # prompt pages; with nothing else running (nothing will
                    # ever free a page) try the real allocation, rolled back
                    # if the pool runs dry, instead of wedging the queue
                    if self.running or not self._bind_group(live, slots, now, publish,
                                                            admitted, trial=True):
                        break
                else:
                    self._bind_group(live, slots, now, publish, admitted)
                queue.pop()
                group.pending_rows.clear()
                continue
            if not self.fits(state):
                break
            queue.pop()
            slot = slots.pop(0)
            self._bind(slot, state, now, publish)
            admitted.append((slot, state))
        return admitted

    def _bind_group(self, live, slots, now: float, publish: bool, admitted,
                    trial: bool = False) -> bool:
        """Bind a group's live branches to free slots: the re-prefilling ones
        allocate their contexts, the fresh siblings wait for the fork. A
        ``trial`` binding is undone (False) when an allocation finds the pool
        dry or too few pages remain for the siblings' fork headroom."""
        bound = []
        try:
            for st, slot in zip(live, slots):
                if not st.await_fork:
                    self._allocate(slot, st, publish)
                bound.append((slot, st))
        except RuntimeError:
            if not trial:
                raise
        n_fork = sum(1 for st in live if st.await_fork)
        if len(bound) < len(live) or (trial and self.cache.num_free < n_fork):
            for slot, st in bound:
                if not st.await_fork:
                    self.cache.free_slot(slot)
            return False
        for slot, st in bound:
            slots.remove(slot)
            st.slot, st.admit_time = slot, now
            self.running[slot] = st
            admitted.append((slot, st))
        return True

    def _allocate(self, slot: int, state: RequestState, publish: bool) -> None:
        """Pages for the state's whole context plus the one-token headroom."""
        ctx = state.context
        self.cache.allocate(slot, self.cache.pages_for(len(ctx) + 1), tokens=ctx,
                            chain=self._chain_of(state), publish=publish)

    def _bind(self, slot: int, state: RequestState, now: float, publish: bool) -> None:
        self._allocate(slot, state, publish)
        state.slot = slot
        state.admit_time = now
        self.running[slot] = state

    def _preempt_one(self, queue: RequestQueue, keep_slot: int) -> Optional[RequestState]:
        keep = self.running.get(keep_slot)
        keep_group = keep.group if keep is not None else None
        victims = [s for s, st in self.running.items()
                   if s != keep_slot and (keep_group is None or st.group is not keep_group)]
        if not victims:
            return None
        return self._evict(victims[-1], queue, keep_slot, demote=True)  # most recent

    def preempt_slot(self, slot: int, queue: RequestQueue) -> Optional[RequestState]:
        """Evict one specific slot (the broken-twin recovery path: its donor
        died before writing its adopted pages). Never demotes: unwritten pages
        must not enter the host tier."""
        if slot not in self.running:
            return None
        return self._evict(slot, queue, -1, demote=False)

    def _evict(self, slot: int, queue: RequestQueue, keep_slot: int,
               demote: bool) -> RequestState:
        """Release ``slot`` and, for a group member, the WHOLE group (its
        siblings alias its pages or advance in lockstep with it), and requeue
        the request at the front with its generated tokens kept: the group
        requeues as its primary. ``demote``: copy each member's complete
        pages to the host tier before freeing them (no-op without a tier)."""
        state = self.running.pop(slot)
        group = state.group
        members = [state]
        if group is not None:
            for s in [s for s, st in self.running.items() if st.group is group]:
                members.append(self.running.pop(s))
            group.pending_rows.clear()
        if self.trace is not None:
            self.trace.instant(
                "preempt", slot, rid=state.request.rid,
                n_preemptions=state.n_preemptions + 1, keep_slot=keep_slot,
                group_size=len(members),
            )
        for st in members:
            if st.slot is not None:
                if demote:
                    self.cache.demote_slot(st.slot, self._chain_of(st))
                self.cache.free_slot(st.slot)
            st.release()
        head = state if group is None else group.primary
        head.n_preemptions += 1
        queue.requeue_front(head)
        return head

    def ensure_decode_page(self, slot: int, queue: RequestQueue) -> None:
        """Make sure ``slot`` owns a WRITABLE page covering position lens[slot]:
        append a page at page boundaries and copy-on-write a shared target
        page, preempting later arrivals if either needs a page the pool
        cannot give."""
        pos = int(self.cache.lens[slot])
        while pos >= len(self.cache.pages_of[slot]) * self.cache.page_size:
            if self.cache.append_page(slot):
                continue
            if self._preempt_one(queue, keep_slot=slot) is None:
                raise RuntimeError(
                    "KV pool exhausted with a single running sequence — "
                    "num_pages is too small for this request"
                )
        while self.cache.needs_cow(slot):
            if self.cache.cow_page(slot):
                continue
            if self._preempt_one(queue, keep_slot=slot) is None:
                raise RuntimeError(
                    "KV pool exhausted while copy-on-write needed a page — "
                    "num_pages is too small for this request"
                )

    # -- fused-decode horizon --------------------------------------------------------
    def reserve_decode_tokens(self, slot: int, n_tokens: int) -> bool:
        """Best-effort page pre-append: grow ``slot``'s owned pages until it
        can take ``n_tokens`` more tokens beyond lens[slot] with no host
        intervention, so a fused (or speculative) window proves its whole page
        budget up front. Never preempts: a dry pool or the per-sequence page
        cap returns False and the caller degrades. Appended pages are ordinary
        owned pages, freed with the slot and filled by later decode either
        way."""
        cache = self.cache
        while cache.capacity_tokens(slot) < n_tokens:
            if len(cache.pages_of[slot]) >= cache.max_pages_per_seq:
                return False
            if not cache.append_page(slot):
                return False
        return True

    def event_free_horizon(self, queue: RequestQueue, tokens_per_step: int = 1) -> int:
        """Largest K such that the next K decode steps need no scheduler
        intervention, the precondition of a fused window
        (make_paged_serve_multistep): the queue is empty (nothing becomes
        admittable mid-horizon), every slot is DECODING with no CoW pending,
        and each has K steps of both owned page capacity and max_new_tokens
        budget. EOS is not predictable: a window may overrun an EOS by up to
        K - 1 tokens, which the engine discards; their writes stay inside the
        slot's owned pages because K never exceeds its capacity.
        ``tokens_per_step`` is a step's token footprint: 1 for plain decode,
        K_draft + 1 for a speculative window."""
        if queue or not self.running:
            return 0
        k = 1 << 30
        for slot, state in self.running.items():
            if state.phase != DECODING or self.cache.needs_cow(slot):
                return 0
            if state.group is not None and state.group.mode == "beam":
                # beam steps put a host-side selection and row reorders
                # between decodes: never fusable
                return 0
            capacity = self.cache.capacity_tokens(slot)
            remaining = state.request.max_new_tokens - len(state.generated)
            k = min(k, capacity // tokens_per_step, max(remaining, 0) // tokens_per_step)
        return max(k, 0)

    def finish(self, slot: int) -> RequestState:
        state = self.running.pop(slot)
        self.cache.free_slot(slot)
        state.release()
        return state
