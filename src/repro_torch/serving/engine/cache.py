"""PagedKVCache: device page pools + the host page allocator.

Port of ``repro.serving.engine.cache``. The device side is one page pool per
block-program entry, (L, num_pages, Hkv, ps, Dh); every layer shares the same
block table, so one host allocation covers the model. The host side is a
free-list allocator over physical page ids plus the block table rows the
kernels read.

``kv_dtype`` ("f32" | "int8" | "int4") selects the pool's element
representation (kvquant.PagedQuantSpec): quantized pools hold {"q", "scale"}
dicts for k and v, prefill and the decode append quantize at scatter time,
and every allocator law below is representation-blind because it keys on
page ids and token hashes, never bytes. "f32" means dense pages in the
model's dtype.

Page 0 is the reserved NULL page: inactive batch slots and unallocated table
entries point at it, so masked scatter writes always land somewhere harmless.

Prefix sharing: every physical page carries a refcount, and pages written by
prefill are registered in an index keyed by the page-granular hash chain of
the tokens they hold (request.page_hash_chain). ``allocate`` maps a new
request's leading chain entries onto live pages (incref, no free-list pop).
A page returns to the free list, and leaves the index, at refcount zero. A
shared page is read-only: the first decode append into one copies it first
(``needs_cow`` / ``cow_page``). Chunk-prefilled pages join the index as their
chunks land (``publish_prefix``), never half-written. A twin admitted in the
same step as its donor adopts the donor's in-flight (allocated, unpublished)
pages too, and waits to be chunked until the donor's written frontier covers
them (``frontier_ready``); if the donor dies first, the twin is handed back to
the engine for a clean re-admit (``take_broken``).

Parallel generation: ``fork_slot`` binds a branch's row to its primary's
pages by reference (a partly filled last page included: the first decode
append copies it), and ``reorder_rows`` rebinds whole rows to snapshots of
other rows for a beam step, increfing before it releases.

The host page tier (``TierManager``, ``host_pool_pages`` > 0): a preempted
or retained slot's complete pages are copied to host RAM under their chain
keys before they free (``demote_slot``), and ``allocate`` promotes a run of
host-resident keys into freshly popped pages, registered as final. Copies
are plain and synchronous on the current stream: a gather from the pool,
``.cpu()``, then ``.to(device)`` and a scatter back in place.
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import Extents, LayoutPaged, MdSpan, all_, submdspan
from repro_torch.models.attention import pack_kv_pages, pack_kv_pages_quant

from .kvquant import KV_DTYPES, kv_pool_bytes, pool_leaves
from .request import page_hash_chain


class TierManager:
    """The host-RAM page tier behind the device pool: a second-level,
    content-keyed prefix index whose pages live in host memory. A page's id,
    its chain key and every offset that reaches it are space-blind, so moving
    its bytes is pure policy:

      - DEMOTION (preemption as swap): a preempted or retained slot's
        complete pages are copied host-side under their chain keys before the
        device pages free; a key already resident skips the copy (pages are
        immutable once published).
      - PROMOTION (resume as prefetch): ``PagedKVCache.allocate`` extends its
        device-index match with ``match_run`` over this index and copies the
        hits into freshly popped device pages at admission.
      - EVICTION: expired retained pages first (``retain_finished_s``
        deadlines), then LRU by last-touch tick. Host pages carry no
        refcounts; dropping one only means recompute.
      - BUDGET: ``begin_step`` re-arms a per-step migration allowance (demote
        and promote both draw on it); overflow truncates the tail of a run.

    The host pools are CPU tensors of each pool leaf's dtype (bf16, int8,
    packed int4 and the scales alike), allocated at the first demotion, so a
    page round-trips bit for bit. Unlike the reference, migrations are not
    padded to power-of-two buckets: nothing here is compiled per shape.
    """

    def __init__(self, cache: "PagedKVCache", host_pages: int, budget_pages_per_step: int = 0):
        if host_pages <= 0:
            raise ValueError("TierManager needs host_pages >= 1")
        self.cache = cache
        self.host_pages = host_pages
        self.budget_pages = int(budget_pages_per_step)
        self._leaves: Optional[List[torch.Tensor]] = None  # host mirrors of the pool leaves
        self._free: deque = deque(range(host_pages))
        self._index: Dict[tuple, int] = {}  # chain key -> host page
        self._key_of: Dict[int, tuple] = {}  # host page -> chain key
        self._tick = 0
        self._touch: Dict[int, int] = {}  # host page -> last-use tick (LRU)
        self._expiry: Dict[int, float] = {}  # host page -> retention deadline
        self._budget_left = self.budget_pages or (1 << 30)
        self.swap_out_pages = 0
        self.swap_out_elided = 0  # demotions satisfied by existing residency
        self.swap_in_pages = 0
        self.prefetch_hits = 0
        self.evictions = 0

    @property
    def resident(self) -> int:
        return len(self._index)

    @property
    def budget_left(self) -> int:
        return self._budget_left

    def begin_step(self) -> None:
        """Re-arm the per-step migration budget (budget 0: unlimited)."""
        self._budget_left = self.budget_pages or (1 << 30)

    def _ensure_pools(self) -> None:
        if self._leaves is None:
            self._leaves = [torch.zeros((t.shape[0], self.host_pages) + tuple(t.shape[2:]),
                                        dtype=t.dtype)
                            for t in pool_leaves(self.cache.pools)]

    def match_run(self, chain, start: int) -> int:
        """Length of the host-resident run extending ``chain[start:]``."""
        n = 0
        for key in chain[start:]:
            if key not in self._index:
                break
            n += 1
        return n

    def _drop(self, hp: int) -> None:
        key = self._key_of.pop(hp, None)
        if key is not None:
            self._index.pop(key, None)
        self._expiry.pop(hp, None)
        self._touch.pop(hp, None)
        self._free.append(hp)

    def _evict_one(self) -> bool:
        """Free one host page: expired retained pages first, then LRU."""
        if not self._key_of:
            return False
        now = time.monotonic()
        expired = [p for p in self._key_of if self._expiry.get(p, float("inf")) <= now]
        victim = min(expired or list(self._key_of), key=lambda p: self._touch.get(p, 0))
        self._drop(victim)
        self.evictions += 1
        if self.cache.trace is not None:
            self.cache.trace.instant("tier_evict", -1, expired=bool(expired),
                                     resident=len(self._index))
        return True

    def release(self, chain) -> int:
        """Drop residency for a context's keys (a request that can never
        resume must not orphan host pages)."""
        n = 0
        for key in chain:
            hp = self._index.get(key)
            if hp is not None:
                self._drop(hp)
                n += 1
        return n

    def demote(self, keys, dev_pages, retain_s: float = 0.0) -> int:
        """Copy device pages host-side under their chain keys (swap-out):
        skips resident keys, truncates to the step's budget, evicts to make
        room; returns the pages copied. Runs while the device pages still
        hold their content, before the slot frees them."""
        todo = [(k, p) for k, p in zip(keys, dev_pages) if k not in self._index]
        self.swap_out_elided += len(keys) - len(todo)
        todo = todo[:self._budget_left]
        while todo and len(self._free) < len(todo):
            if not self._evict_one():
                todo = todo[:len(self._free)]
        if not todo:
            return 0
        self._ensure_pools()
        hps = [self._free.popleft() for _ in todo]
        self._tick += 1
        for (key, _), hp in zip(todo, hps):
            self._index[key] = hp
            self._key_of[hp] = key
            self._touch[hp] = self._tick
            if retain_s > 0:
                self._expiry[hp] = time.monotonic() + retain_s
        src = torch.tensor([p for _, p in todo], dtype=torch.long, device=self.cache.device)
        dst = torch.tensor(hps, dtype=torch.long)
        for host, leaf in zip(self._leaves, pool_leaves(self.cache.pools)):
            host[:, dst] = leaf[:, src].cpu()
        n = len(todo)
        self._budget_left -= n
        self.swap_out_pages += n
        return n

    def promote(self, keys, dst_pages) -> int:
        """Copy host-resident pages into freshly popped device pages (swap-in
        at admission). The host copies stay resident, so a later demotion of
        the same content is free. The caller owns ``dst_pages`` and caps the
        run by ``budget_left``."""
        n = len(keys)
        if n == 0:
            return 0
        hps = [self._index[k] for k in keys]
        self._tick += 1
        for hp in hps:
            self._touch[hp] = self._tick
        src = torch.tensor(hps, dtype=torch.long)
        dst = torch.tensor(list(dst_pages), dtype=torch.long, device=self.cache.device)
        for host, leaf in zip(self._leaves, pool_leaves(self.cache.pools)):
            leaf[:, dst] = host[:, src].to(leaf.device)
        self._budget_left -= n
        self.swap_in_pages += n
        self.prefetch_hits += n
        return n

    def reset_counters(self) -> None:
        """Zero the migration counters; residency stays (a warm tier stays warm)."""
        self.swap_out_pages = 0
        self.swap_out_elided = 0
        self.swap_in_pages = 0
        self.prefetch_hits = 0
        self.evictions = 0


class PagedKVCache:
    def __init__(self, model, *, num_pages: int, page_size: int, max_batch: int,
                 max_pages_per_seq: int, prefix_sharing: bool = True, kv_dtype: str = "f32",
                 host_pool_pages: int = 0, swap_budget_pages_per_step: int = 0):
        if num_pages < 2:
            raise ValueError("need >= 2 pages (page 0 is the reserved null page)")
        if kv_dtype not in KV_DTYPES:
            raise ValueError(f"kv_dtype {kv_dtype!r} not in {sorted(KV_DTYPES)}")
        self.cfg = model.cfg
        self.device = model.device
        self.page_size = page_size
        self.num_pages = num_pages
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq
        self.prefix_sharing = prefix_sharing
        self.kv_dtype = kv_dtype
        self.kv_spec = KV_DTYPES[kv_dtype]
        self.pools = model.init_paged_cache(num_pages, page_size, kv_spec=self.kv_spec)
        self._free: deque = deque(range(1, num_pages))
        # block-table rows + live lengths by batch slot (null-page filled)
        self.tables = np.zeros((max_batch, max_pages_per_seq), np.int32)
        self.lens = np.zeros((max_batch,), np.int32)
        # device mirrors of tables/lens: allocator events mark their slot dirty
        # and device_state() uploads before the next step; routine decode
        # appends advance the device lens inside the step (adopt_lens_device)
        self._tables_dev = torch.zeros((max_batch, max_pages_per_seq), dtype=torch.int32,
                                       device=self.device)
        self._lens_dev = torch.zeros((max_batch,), dtype=torch.int32, device=self.device)
        self._dirty_slots: set = set()
        self.pages_of: Dict[int, List[int]] = {}
        self.ref = np.zeros((num_pages,), np.int32)  # ref[0] stays 0
        # prefix index: chain key -> physical page, and the reverse map
        self._index: Dict[tuple, int] = {}
        self._key_of: Dict[int, tuple] = {}
        # pages of a just-allocated slot already holding its prefix
        self._shared_upto: Dict[int, int] = {}
        # chunked prefill: chain entries registered as their chunks land
        self._deferred: Dict[int, List[tuple]] = {}
        self._published: Dict[int, int] = {}
        # same-step twin adoption: chain key -> (donor slot, page index) for
        # every deferred, unpublished key; adopter -> (donor, pages it needs
        # written); adopters whose donor died before writing them
        self._inflight: Dict[tuple, Tuple[int, int]] = {}
        self._frontier_deps: Dict[int, Tuple[int, int]] = {}
        self._broken: set = set()
        # the host page tier; None without one (every tier touchpoint checks)
        self.tier = (TierManager(self, host_pool_pages, swap_budget_pages_per_step)
                     if host_pool_pages > 0 else None)
        self.pages_shared_total = 0
        self.cow_copies = 0
        self.peak_pages_in_use = 0
        self.branch_forks = 0  # fork_slot calls
        self.beam_reorders = 0  # reorder_rows calls that moved a row
        self.trace = None  # serving.telemetry.EngineTrace, attached by the engine

    # -- allocator ---------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free)

    @property
    def pages_in_use(self) -> int:
        return self.num_pages - 1 - len(self._free)

    def pages_for(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def capacity_tokens(self, slot: int) -> int:
        """Owned page capacity beyond the slot's current length."""
        return len(self.pages_of[slot]) * self.page_size - int(self.lens[slot])

    def _take_free(self) -> int:
        p = self._free.popleft()
        self.ref[p] = 1
        self.peak_pages_in_use = max(self.peak_pages_in_use, self.pages_in_use)
        return p

    def _chain(self, tokens) -> List[tuple]:
        if not self.prefix_sharing or tokens is None:
            return []
        return page_hash_chain(tokens, self.page_size)

    def _match_prefix(self, chain) -> List[int]:
        """Leading run of live pages already holding this context's pages."""
        matched = []
        for key in chain:
            page = self._index.get(key)
            if page is None:
                break
            matched.append(page)
        return matched

    def new_pages_needed(self, tokens, chain=None) -> int:
        """Free-list pages a request with this context must pop to run one more
        token (its admission cost); shared-prefix pages are free."""
        if chain is None or not self.prefix_sharing:
            chain = self._chain(tokens)
        return self.pages_for(len(tokens) + 1) - len(self._match_prefix(chain))

    def allocate(self, slot: int, n_pages: int, tokens=None, chain=None,
                 publish: bool = True) -> List[int]:
        """Bind ``n_pages`` logical pages to ``slot``: the leading run found in
        the prefix index is adopted by reference, a following run of
        host-resident keys is promoted into freshly popped pages (registered
        at once: their content is final), and the rest pops from the free
        list. Fresh content-bearing pages are registered in the index at once
        (``publish``: monolithic prefill fills them this step) or deferred to
        ``publish_prefix`` (chunked prefill). A deferred allocation also
        adopts, past those runs, one donor's in-flight pages at matching page
        indices (same-step twin adoption), gated by ``frontier_ready``."""
        if n_pages > self.max_pages_per_seq:
            raise RuntimeError(
                f"sequence needs {n_pages} pages > max_pages_per_seq {self.max_pages_per_seq}"
            )
        if chain is None or not self.prefix_sharing:
            chain = self._chain(tokens)
        shared = self._match_prefix(chain)[:n_pages]
        base = len(shared)
        promote_keys: List[tuple] = []
        if self.tier is not None and base < n_pages:
            k = min(self.tier.match_run(chain, base), n_pages - base, self.tier.budget_left)
            promote_keys = list(chain[base:base + k])
        pos = base + len(promote_keys)
        donor: Optional[int] = None
        twin_pages: List[int] = []
        if not publish and self.prefix_sharing:
            while pos + len(twin_pages) < min(len(chain), n_pages):
                ent = self._inflight.get(chain[pos + len(twin_pages)])
                if ent is None:
                    break
                d_slot, d_idx = ent
                if (d_idx != pos + len(twin_pages) or d_slot == slot
                        or (donor is not None and d_slot != donor)):
                    break
                donor = d_slot
                twin_pages.append(self.pages_of[d_slot][d_idx])
        n_new = n_pages - base - len(twin_pages)
        if n_new > len(self._free):
            raise RuntimeError(
                f"pool exhausted: want {n_new} new pages ({n_pages} total, {base} shared), "
                f"free {len(self._free)}"
            )
        for p in shared + twin_pages:
            self.ref[p] += 1
        self.pages_shared_total += base + len(twin_pages)
        fresh = [self._take_free() for _ in range(n_new)]
        k = len(promote_keys)
        pages = shared + fresh[:k] + twin_pages + fresh[k:]
        if promote_keys:
            self.tier.promote(promote_keys, fresh[:k])
            self._register(promote_keys, pages, base)
            if self.trace is not None:
                self.trace.instant("prefetch", slot, pages=k)
        adopted = pos + len(twin_pages)
        if twin_pages:
            self._frontier_deps[slot] = (donor, adopted)
            if self.trace is not None:
                self.trace.instant("twin_adopt", slot, donor=donor, pages=len(twin_pages))
        fresh_keys = list(chain[adopted:min(len(chain), n_pages)])
        if publish:
            self._register(fresh_keys, pages, adopted)
        else:
            self._deferred[slot] = fresh_keys
            for j, key in enumerate(fresh_keys):
                self._inflight.setdefault(key, (slot, adopted + j))
        self.pages_of[slot] = pages
        self._shared_upto[slot] = adopted
        self.tables[slot, :] = 0
        self.tables[slot, :len(pages)] = pages
        self._dirty_slots.add(slot)
        if self.trace is not None:
            self.trace.instant("alloc", slot, pages=n_pages, shared=adopted, free=len(self._free))
        return pages

    def _register(self, keys: List[tuple], pages: List[int], start: int) -> None:
        for i, key in enumerate(keys, start=start):
            if key not in self._index:
                self._index[key] = pages[i]
                self._key_of[pages[i]] = key

    def publish_prefix(self, slot: int, written_pages: Optional[int] = None) -> None:
        """Register a chunk-prefilled slot's fresh pages in the prefix index as
        their content becomes final: pages with index < ``written_pages``
        (None = all: the prefill completed). Published keys leave the
        in-flight map, and twins whose adopted run is now written are
        released."""
        keys = self._deferred.get(slot)
        if not keys:
            return
        start = self._shared_upto.get(slot, 0)
        done = self._published.get(slot, 0)
        end = len(keys) if written_pages is None else max(0, min(written_pages - start, len(keys)))
        if end > done:
            self._register(keys[done:end], self.pages_of[slot], start + done)
            for key in keys[done:end]:
                ent = self._inflight.get(key)
                if ent is not None and ent[0] == slot:
                    self._inflight.pop(key)
        if end >= len(keys):
            self._deferred.pop(slot, None)
            self._published.pop(slot, None)
        elif end > done:
            self._published[slot] = end
        final = start + end
        for adopter, (d_slot, need) in list(self._frontier_deps.items()):
            if d_slot == slot and need <= final:
                self._frontier_deps.pop(adopter)

    def adopted_pages(self, slot: int) -> int:
        """Pages adopted from the prefix index at allocation: the compute-skip
        extent and the write-protected prefix of chunk scatters."""
        return self._shared_upto.get(slot, 0)

    def write_table_row(self, slot: int) -> np.ndarray:
        """The slot's table row with adopted shared pages and unallocated
        entries nulled to page 0 (the chunk scatter's WRITE view)."""
        row = self.tables[slot].copy()
        row[:self.adopted_pages(slot)] = 0
        return row

    def append_page(self, slot: int) -> bool:
        """Grow a running sequence by one page; False when the pool is empty."""
        pages = self.pages_of[slot]
        if len(pages) >= self.max_pages_per_seq:
            raise RuntimeError(f"slot {slot} hit max_pages_per_seq {self.max_pages_per_seq}")
        if not self._free:
            return False
        p = self._take_free()
        pages.append(p)
        self.tables[slot, len(pages) - 1] = p
        self._dirty_slots.add(slot)
        if self.trace is not None:
            self.trace.instant("append_page", slot, page=p, free=len(self._free))
        return True

    def _release_page(self, p: int) -> None:
        self.ref[p] -= 1
        if self.ref[p] < 0:
            raise RuntimeError(f"page {p} refcount went negative")
        if self.ref[p] == 0:
            key = self._key_of.pop(p, None)
            if key is not None:
                self._index.pop(key, None)
            self._free.append(p)

    def free_slot(self, slot: int) -> None:
        """Release the slot's pages (idempotent); shared pages survive with the
        other holders, and a mid-prefill release discards the deferred keys."""
        released = self.pages_of.pop(slot, [])
        if released and self.trace is not None:
            self.trace.instant("free_slot", slot, pages=len(released))
        for p in released:
            self._release_page(p)
        self._drop_inflight(slot)
        self._shared_upto.pop(slot, None)
        self._deferred.pop(slot, None)
        self._published.pop(slot, None)
        self.tables[slot, :] = 0
        self.lens[slot] = 0
        self._dirty_slots.add(slot)

    def _drop_inflight(self, slot: int) -> None:
        """Unwind a dying slot's twin bookkeeping: its unpublished in-flight
        keys leave the map, and adopters still waiting on it as a donor are
        marked broken (their adopted pages were never written)."""
        for key in self._deferred.get(slot, []):
            ent = self._inflight.get(key)
            if ent is not None and ent[0] == slot:
                self._inflight.pop(key)
        for adopter, (d_slot, _) in list(self._frontier_deps.items()):
            if d_slot == slot:
                self._frontier_deps.pop(adopter)
                self._broken.add(adopter)
        self._frontier_deps.pop(slot, None)
        self._broken.discard(slot)

    def frontier_ready(self, slot: int) -> bool:
        """False while the slot waits on a twin donor's written frontier:
        chunk dispatch skips it (its adopted pages are not written yet)."""
        return slot not in self._frontier_deps

    def take_broken(self) -> List[int]:
        """Slots whose twin donor died before writing their adopted pages,
        cleared on read; the engine preempts them back to the queue."""
        out = sorted(self._broken)
        self._broken.clear()
        return out

    # -- host tier ---------------------------------------------------------------
    def demote_slot(self, slot: int, chain, retain_s: float = 0.0) -> int:
        """Swap a slot's COMPLETE pages out to the host tier before freeing
        them (preemption as swap, finished-session retention). A partial page
        holds fewer tokens than its chain key claims, and a twin adopter
        whose frontier is unsatisfied holds unwritten pages: neither demotes.
        Must run before free_slot."""
        if self.tier is None or not chain or slot in self._frontier_deps:
            return 0
        pages = self.pages_of.get(slot)
        if not pages:
            return 0
        n = min(int(self.lens[slot]) // self.page_size, len(pages), len(chain))
        if n <= 0:
            return 0
        moved = self.tier.demote(chain[:n], pages[:n], retain_s=retain_s)
        if moved and self.trace is not None:
            self.trace.instant("swap_out", slot, pages=moved, host_resident=self.tier.resident)
        return moved

    def release_host(self, chain) -> int:
        """Drop host-tier residency for a context that can never resume."""
        if self.tier is None or not chain:
            return 0
        return self.tier.release(chain)

    def check_conservation(self) -> None:
        """Refcount mass equals slot ownership; live + free covers the pool;
        no refcount is negative; the host tier's free list and index
        partition its pages."""
        owned = sum(len(v) for v in self.pages_of.values())
        total_ref = int(self.ref.sum())
        if total_ref != owned:
            raise AssertionError(f"refcount mass {total_ref} != owned pages {owned}")
        if (self.ref < 0).any():
            raise AssertionError("negative refcount")
        live = int((self.ref[1:] > 0).sum())
        if live + len(self._free) != self.num_pages - 1:
            raise AssertionError(f"live {live} + free {len(self._free)} != pool {self.num_pages - 1}")
        t = self.tier
        if t is not None:
            if len(t._free) + len(t._index) != t.host_pages:
                raise AssertionError(f"host free {len(t._free)} + resident {len(t._index)} "
                                     f"!= host pool {t.host_pages}")
            for key, hp in t._index.items():
                if t._key_of.get(hp) != key:
                    raise AssertionError(f"host page {hp} index/reverse-map mismatch")

    # -- parallel generation: forks and beam reorders ----------------------------
    def fork_slot(self, src: int, dst: int, n_tokens: int) -> List[int]:
        """Bind ``dst`` as a fork of ``src`` at context length ``n_tokens``:
        the pages covering those tokens are adopted by reference (n branches
        of one prompt cost ~1x its pages), padded with fresh pages to the
        usual +1-token decode headroom. The first divergent write into a
        shared page goes through the ordinary CoW path; the fork copies
        nothing. Raises when the headroom pages do not exist."""
        src_pages = self.pages_of[src]
        n_alias = min(self.pages_for(n_tokens), len(src_pages))
        n_total = max(self.pages_for(n_tokens + 1), n_alias)
        if n_total > self.max_pages_per_seq:
            raise RuntimeError(
                f"fork needs {n_total} pages > max_pages_per_seq {self.max_pages_per_seq}"
            )
        if n_total - n_alias > len(self._free):
            raise RuntimeError(
                f"pool exhausted: fork wants {n_total - n_alias} fresh pages, "
                f"free {len(self._free)}"
            )
        shared = src_pages[:n_alias]
        for p in shared:
            self.ref[p] += 1
        self.pages_shared_total += len(shared)
        pages = list(shared) + [self._take_free() for _ in range(n_total - n_alias)]
        self.pages_of[dst] = pages
        self._shared_upto[dst] = n_alias
        self.tables[dst, :] = 0
        self.tables[dst, :len(pages)] = pages
        self.lens[dst] = n_tokens
        self._dirty_slots.add(dst)
        self.branch_forks += 1
        if self.trace is not None:
            self.trace.instant("fork", dst, src=src, shared=n_alias, free=len(self._free))
        return pages

    def reorder_rows(self, assignment: Dict[int, int]) -> None:
        """Rebind each child slot's row to a SNAPSHOT of its parent slot's
        pages and length: a beam step's hypothesis permutation as block-table
        surgery. Every new reference increfs BEFORE any old page is released,
        so a page held on both sides never passes through refcount 0, and
        nothing is copied here (divergence is the next decode write's CoW).
        Identity entries are skipped; an identity assignment is free."""
        live = {c: p for c, p in assignment.items() if c != p}
        if not live:
            return
        snap = {p: (list(self.pages_of[p]), int(self.lens[p])) for p in set(live.values())}
        for p in live.values():
            for page in snap[p][0]:
                self.ref[page] += 1
        self.pages_shared_total += sum(len(snap[p][0]) for p in live.values())
        for c in live:
            for page in self.pages_of.get(c, []):
                self._release_page(page)
        for c, p in live.items():
            pages, length = snap[p]
            self.pages_of[c] = list(pages)
            self._drop_inflight(c)
            self._shared_upto.pop(c, None)
            self._deferred.pop(c, None)
            self._published.pop(c, None)
            self.tables[c, :] = 0
            self.tables[c, :len(pages)] = pages
            self.lens[c] = length
            self._dirty_slots.add(c)
        self.beam_reorders += 1
        if self.trace is not None:
            self.trace.instant("beam_reorder", min(live), moves=len(live), free=len(self._free))

    # -- device-resident layout state ----------------------------------------------
    def set_len(self, slot: int, n: int) -> None:
        """Host-side length assignment (an allocator event: the slot's device
        row is re-uploaded before the next step)."""
        self.lens[slot] = n
        self._dirty_slots.add(slot)

    def bump_len(self, slot: int, n: int = 1) -> None:
        """Advance the host lens mirror after a decode step appended ``n``
        tokens; the step already advanced the device lens itself."""
        self.lens[slot] += n

    def device_state(self) -> Tuple[torch.Tensor, torch.Tensor]:
        """The device (tables, lens) mirrors, with pending allocator events
        applied (one upload of each host array)."""
        if self._dirty_slots:
            self._tables_dev.copy_(torch.from_numpy(self.tables))
            self._lens_dev = torch.from_numpy(self.lens.copy()).to(self.device)
            self._dirty_slots.clear()
        return self._tables_dev, self._lens_dev

    def adopt_lens_device(self, lens_dev: torch.Tensor) -> None:
        """Take over the serve step's device-side lens output."""
        self._lens_dev = lens_dev

    # -- copy-on-write -----------------------------------------------------------
    def needs_cow(self, slot: int) -> bool:
        """True when the page the next decode token scatters into is shared."""
        pos = int(self.lens[slot])
        pages = self.pages_of[slot]
        pi = pos // self.page_size
        return pi < len(pages) and self.ref[pages[pi]] > 1

    def cow_page(self, slot: int) -> bool:
        """Privatize the page covering position lens[slot]: copy it (all
        layers) to a fresh page, swap the table entry, drop the donor's
        refcount. False when no free page exists."""
        if not self._free:
            return False
        pi = int(self.lens[slot]) // self.page_size
        pages = self.pages_of[slot]
        old = pages[pi]
        new = self._take_free()
        for t in pool_leaves(self.pools):  # a quantized page: its bytes AND its scales
            t[:, new] = t[:, old]
        pages[pi] = new
        self.tables[slot, pi] = new
        self.ref[old] -= 1
        self.cow_copies += 1
        self._dirty_slots.add(slot)
        if self.trace is not None:
            self.trace.instant("cow", slot, src=old, dst=new)
        return True

    # -- device writes -----------------------------------------------------------
    def write_prefill(self, slot: int, caches) -> None:
        """Scatter a single-sequence prefill's KV ([{"k", "v": (L, 1, Hkv, S,
        Dh)}], S == n_pages * ps) into this slot's pages, in place, quantizing
        over a quantized pool. Pages adopted from the prefix index already
        hold these values, so only the fresh tail is written."""
        ps = self.page_size
        n = caches[0]["k"].shape[3] // ps
        start = min(self._shared_upto.pop(slot, 0), n)
        if start >= n:
            return
        pages = torch.tensor(self.pages_of[slot][start:n], dtype=torch.long, device=self.device)
        for pool, c in zip(self.pools, caches):
            k, v = c["k"][:, :, :, start * ps:], c["v"][:, :, :, start * ps:]
            if self.kv_spec is None:
                pack_kv_pages(pool, k, v, pages)
            else:
                pack_kv_pages_quant(pool, k, v, pages, spec=self.kv_spec)

    # -- mdspan view -------------------------------------------------------------
    def shared_pages_of(self, slot: int) -> Tuple[int, ...]:
        """The slot's pages other holders also reference (refcount > 1)."""
        return tuple(p for p in self.pages_of[slot] if self.ref[p] > 1)

    def layout_for(self, slot: int) -> LayoutPaged:
        """The LayoutPaged mapping of one sequence's cache over the flat pool.
        Pages co-owned with other sequences surface as ``shared_pages``, so
        ``is_unique()`` is False exactly while the table references a
        refcount>1 page — the formal statement of the CoW obligation."""
        pages = self.pages_of[slot]
        hkv, dh = self.cfg.n_kv_heads, self.cfg.head_dim
        return LayoutPaged(
            Extents.fully_dynamic(1, hkv, len(pages) * self.page_size, dh),
            (tuple(pages),),
            self.page_size,
            self.num_pages,
            self.shared_pages_of(slot),
        )

    def _flat_codomain(self, leaf, layer: int) -> torch.Tensor:
        """One layer's pool as the layout's flat codomain, decoded through the
        spec when the pool is quantized — the layout algebra never sees the
        representation."""
        if self.kv_spec is None:
            return leaf[layer].reshape(-1)
        return self.kv_spec.decode_pages(leaf["q"][layer], leaf["scale"][layer]).reshape(-1)

    def dense_view(self, slot: int, entry: int = 0, layer: int = 0):
        """(k, v), each (Hkv, len, Dh), gathered through layout_for(slot)'s
        offsets — the generic read path of the paged layout, a test's view of
        what the scatters wrote. Quantized pools are decoded first, then
        gathered through the SAME offsets."""
        offs = self.layout_for(slot).offsets_dense(self.device)[0]  # (Hkv, n_pages*ps, Dh)
        length = int(self.lens[slot])
        return tuple(self._flat_codomain(self.pools[entry][name], layer)[offs][:, :length, :]
                     for name in ("k", "v"))

    def chunk_view(self, slot: int, start: int, stop: int, entry: int = 0,
                   layer: int = 0) -> MdSpan:
        """The mdspan of one prefill chunk: LITERALLY
        ``submdspan(seq_view, all_, all_, (start, stop), all_)`` over the flat
        pool (core/submdspan.py). Returns the K span; its layout is again a
        LayoutPaged whose rows are trimmed to the chunk's pages, whose
        ``pos_offset`` carries partial-page starts, and whose ``is_unique()``
        is True exactly when the chunk lies past every shared page."""
        span = MdSpan.over(self._flat_codomain(self.pools[entry]["k"], layer),
                           self.layout_for(slot))
        return submdspan(span, all_, all_, (start, stop), all_)

    # -- stats -------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        self.check_conservation()
        out = {
            "peak_pages_in_use": self.peak_pages_in_use,
            "pages_shared": self.pages_shared_total,
            "cow_copies": self.cow_copies,
            "branch_forks": self.branch_forks,
            "beam_reorders": self.beam_reorders,
            "kv_pool_bytes": kv_pool_bytes(self.pools),
        }
        t = self.tier
        if t is not None:
            out.update(
                swap_out_pages=t.swap_out_pages, swap_out_elided=t.swap_out_elided,
                swap_in_pages=t.swap_in_pages, prefetch_hits=t.prefetch_hits,
                evictions=t.evictions, host_pages_resident=t.resident,
                host_pool_pages=t.host_pages,
            )
        return out

    def reset_stats(self) -> None:
        self.pages_shared_total = 0
        self.cow_copies = 0
        self.branch_forks = 0
        self.beam_reorders = 0
        self.peak_pages_in_use = self.pages_in_use
        if self.tier is not None:
            self.tier.reset_counters()
