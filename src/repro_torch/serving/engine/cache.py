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

Not ported yet: the host page tier and branch forks / beam row reorders.
"""
from __future__ import annotations

from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.attention import pack_kv_pages, pack_kv_pages_quant

from .kvquant import KV_DTYPES, kv_pool_bytes, pool_leaves
from .request import page_hash_chain


class PagedKVCache:
    def __init__(self, model, *, num_pages: int, page_size: int, max_batch: int,
                 max_pages_per_seq: int, prefix_sharing: bool = True, kv_dtype: str = "f32"):
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
        self.pages_shared_total = 0
        self.cow_copies = 0
        self.peak_pages_in_use = 0
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
        the prefix index is adopted by reference, the rest pops from the free
        list. Fresh content-bearing pages are registered in the index at once
        (``publish``: monolithic prefill fills them this step) or deferred to
        ``publish_prefix`` (chunked prefill). A deferred allocation also
        adopts, past that run, one donor's in-flight pages at matching page
        indices (same-step twin adoption), gated by ``frontier_ready``."""
        if n_pages > self.max_pages_per_seq:
            raise RuntimeError(
                f"sequence needs {n_pages} pages > max_pages_per_seq {self.max_pages_per_seq}"
            )
        if chain is None or not self.prefix_sharing:
            chain = self._chain(tokens)
        shared = self._match_prefix(chain)[:n_pages]
        base = len(shared)
        donor: Optional[int] = None
        twin_pages: List[int] = []
        if not publish and self.prefix_sharing:
            while base + len(twin_pages) < min(len(chain), n_pages):
                ent = self._inflight.get(chain[base + len(twin_pages)])
                if ent is None:
                    break
                d_slot, d_idx = ent
                if (d_idx != base + len(twin_pages) or d_slot == slot
                        or (donor is not None and d_slot != donor)):
                    break
                donor = d_slot
                twin_pages.append(self.pages_of[d_slot][d_idx])
        adopted = base + len(twin_pages)
        n_new = n_pages - adopted
        if n_new > len(self._free):
            raise RuntimeError(
                f"pool exhausted: want {n_new} new pages ({n_pages} total, {adopted} shared), "
                f"free {len(self._free)}"
            )
        for p in shared + twin_pages:
            self.ref[p] += 1
        self.pages_shared_total += adopted
        pages = shared + twin_pages + [self._take_free() for _ in range(n_new)]
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

    def check_conservation(self) -> None:
        """Refcount mass equals slot ownership; live + free covers the pool;
        no refcount is negative."""
        owned = sum(len(v) for v in self.pages_of.values())
        total_ref = int(self.ref.sum())
        if total_ref != owned:
            raise AssertionError(f"refcount mass {total_ref} != owned pages {owned}")
        if (self.ref < 0).any():
            raise AssertionError("negative refcount")
        live = int((self.ref[1:] > 0).sum())
        if live + len(self._free) != self.num_pages - 1:
            raise AssertionError(f"live {live} + free {len(self._free)} != pool {self.num_pages - 1}")

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

    def dense_view(self, slot: int, entry: int = 0, layer: int = 0):
        """(k, v), each (Hkv, len, Dh): the slot's pages gathered in logical
        order (decoded through the spec for a quantized pool) and cut at its
        length — a test's view of what the scatters wrote."""
        pages = torch.tensor(self.pages_of[slot], dtype=torch.long, device=self.device)
        length = int(self.lens[slot])
        out = []
        for name in ("k", "v"):
            leaf = self.pools[entry][name]
            if self.kv_spec is None:
                g = leaf[layer][pages]  # (n, Hkv, ps, Dh)
            else:
                g = self.kv_spec.decode_pages(leaf["q"][layer][pages], leaf["scale"][layer][pages])
            out.append(g.transpose(0, 1).reshape(g.shape[1], -1, g.shape[3])[:, :length])
        return out[0], out[1]

    # -- stats -------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        self.check_conservation()
        return {
            "peak_pages_in_use": self.peak_pages_in_use,
            "pages_shared": self.pages_shared_total,
            "cow_copies": self.cow_copies,
            "kv_pool_bytes": kv_pool_bytes(self.pools),
        }

    def reset_stats(self) -> None:
        self.pages_shared_total = 0
        self.cow_copies = 0
        self.peak_pages_in_use = self.pages_in_use
