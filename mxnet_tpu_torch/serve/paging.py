"""Paged KV-cache pool ledger: fixed-size pages, per-slot block tables,
shared prefixes (counterpart of ``mxnet_tpu/serve/paging.py``).

- **Pages.** The device carries one pool of ``num_pages + 1`` physical
  pages per cache entry (``GPTModel.cache_spec_paged``); page
  ``num_pages`` is the *sink*: unleased block-table entries point at it,
  so pad writes land somewhere harmless and masked reads of unleased
  territory never enter a sum.
- **Block tables.** Each slot owns a ``[max_pages]`` int32 row mapping
  logical page ``i`` (token positions ``[i*page_size, (i+1)*page_size)``)
  to a physical page. Slots lease pages as their position advances and
  release them at retire, so a request holds the KV rows it uses, not
  ``max_len`` of them.
- **Shared prefixes (copy-on-write).** Completed prefills publish their
  prompt pages into a chained-hash prefix cache (page ``i`` keyed by the
  sha1 of tokens ``[0, i*page_size + chunk_len)``, so a match at page
  ``i`` implies a match of the whole prefix). A new request maps the
  matching pages instead of prefilling them; pages are refcounted, and a
  write into a page with refs > 1 first *forks* it (``writable`` names
  the pages, the engine copies them on the device). A hash collision is
  detected by comparing tokens and stops the match walk.
- **Eviction & preemption.** Allocation first evicts LRU prefix entries;
  if the pool is still exhausted :class:`OutOfPages` tells the engine to
  preempt a slot, whose request resumes exactly by re-prefilling
  ``prompt + generated``.

Pure host bookkeeping (numpy + stdlib). The ledger reports the JAX
module's ``mxnet_serve_page_*`` families at its sites and keeps the
counters ``stats()`` returns; a ``threading.Lock`` stands in for the JAX
module's witnessed lock. ``prefix_summary`` is the bounded advert
``/healthz`` carries for the router; ``adopt_prefix`` is the migration
import: it publishes shipped pages as prefix-cache entries on freshly
leased physical pages, which the engine then fills with the payload.
"""
from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import metrics as _metrics
from ..base import MXNetError

__all__ = ["PagePool", "OutOfPages", "pages_for", "prefix_key"]


class OutOfPages(MXNetError):
    """The page pool cannot satisfy a lease even after evicting every
    reclaimable prefix-cache entry (the engine's preemption trigger)."""


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold ``tokens`` KV rows (ceil division)."""
    return -(-int(tokens) // int(page_size))


def prefix_key(tokens: Sequence[int]) -> int:
    """The chain key of a token prefix (:meth:`PagePool._hash`)."""
    return PagePool._hash(tuple(int(t) for t in tokens))


@dataclasses.dataclass
class _PrefixEntry:
    """One cached page of a published prompt prefix: ``prefix_len`` is the
    token length its chain covers, ``chunk`` the tokens stored in this page
    (for collision checks)."""
    page: int
    page_index: int
    chunk: Tuple[int, ...]
    prefix_len: int


class PagePool:
    """Host-side ledger for a fixed-size-page KV pool.

    Parameters
    ----------
    num_pages : leasable physical pages (the device pools carry one extra
        sink page at index ``num_pages``)
    page_size : tokens per page
    max_len : per-request KV capacity; a page multiple, so the gathered
        cache length equals the contiguous layout's
    slots : block-table rows (the engine's ``max_batch_size``)
    prefix_cache : publish and match shared prompt prefixes
    """

    def __init__(self, num_pages: int, page_size: int, max_len: int,
                 slots: int, prefix_cache: bool = True):
        if page_size < 1:
            raise MXNetError("page_size must be >= 1")
        if num_pages < 1:
            raise MXNetError("num_pages must be >= 1")
        if max_len % page_size:
            raise MXNetError(
                f"max_len ({max_len}) must be a multiple of page_size "
                f"({page_size}) so the paged gather length equals the "
                f"contiguous cache length")
        if num_pages * page_size < max_len:
            raise MXNetError(
                f"page pool ({num_pages} pages x {page_size}) cannot hold "
                f"even one max_len ({max_len}) request")
        self.num_pages = int(num_pages)
        self.page_size = int(page_size)
        self.max_pages = max_len // page_size
        self.slots = int(slots)
        self.sink = self.num_pages          # physical sink page index
        self._ref = np.zeros(self.num_pages, np.int32)
        # free stack: low indices leased first
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._tables = np.full((self.slots, self.max_pages), self.sink,
                               np.int32)
        self._leased = np.zeros(self.slots, np.int32)    # entries per slot
        self.prefix_cache_enabled = bool(prefix_cache)
        # the engine thread mutates the ledger; stats() may be read from
        # any thread
        self._lock = threading.Lock()
        # LRU: key -> list of entries (collision bucket)
        self._prefix: "OrderedDict[int, List[_PrefixEntry]]" = OrderedDict()
        self.leases = 0
        self.cow_forks = 0
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.prefix_tokens_saved = 0
        self.prefix_collisions = 0
        self.prefix_evictions = 0
        _metrics.SERVE_PAGE_POOL.set(self.num_pages)

    # ------------------------------------------------------------ accounting
    def free_pages(self) -> int:
        return len(self._free)

    def pages_in_use(self) -> int:
        return self.num_pages - len(self._free)

    def cached_pages(self) -> int:
        """Pages held ONLY by the prefix cache (reclaimable)."""
        with self._lock:
            return self._cache_only_pages()

    def _cache_only_pages(self) -> int:
        pages = {e.page for bucket in self._prefix.values() for e in bucket}
        return sum(1 for p in pages if self._ref[p] == 1)

    def table(self, slot: int) -> np.ndarray:
        """The slot's block-table row (a live view: copy it before handing
        it to a dispatch)."""
        return self._tables[slot]

    def check_consistent(self):
        """Refcounts must equal table references plus cache references, and
        the free list must hold exactly the zero-ref pages."""
        with self._lock:
            ref = np.zeros(self.num_pages, np.int64)
            for s in range(self.slots):
                for p in self._tables[s]:
                    if p != self.sink:
                        ref[p] += 1
            seen = set()
            for bucket in self._prefix.values():
                for e in bucket:
                    # one cache ref per entry
                    assert e.page not in seen, "duplicate cache entry page"
                    seen.add(e.page)
                    ref[e.page] += 1
            assert (ref == self._ref).all(), \
                f"refcount drift: {ref.tolist()} vs {self._ref.tolist()}"
            free = {p for p in range(self.num_pages) if self._ref[p] == 0}
            assert free == set(self._free), "free list drift"

    # ------------------------------------------------------------ allocation
    def _alloc(self, n: int) -> List[int]:
        """Pop ``n`` free pages, evicting LRU prefix entries as needed."""
        while len(self._free) < n and self._evict_one():
            pass
        if len(self._free) < n:
            raise OutOfPages(
                f"page pool exhausted: need {n}, "
                f"{len(self._free)} free of {self.num_pages} "
                f"({self.pages_in_use()} leased)")
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._ref[p] = 1
        self.leases += n
        _metrics.SERVE_PAGE_LEASES.inc(n)
        self._observe()
        return out

    def _decref(self, page: int):
        if page == self.sink:
            return
        self._ref[page] -= 1
        assert self._ref[page] >= 0, f"page {page} over-freed"
        if self._ref[page] == 0:
            self._free.append(int(page))
        self._observe()

    def _observe(self):
        _metrics.SERVE_PAGE_IN_USE.set(self.pages_in_use())

    # ------------------------------------------------------------ leasing
    def lease(self, slot: int, tokens: int) -> int:
        """Grow ``slot``'s table to cover ``tokens`` KV rows. Returns the
        number of pages newly leased; raises :class:`OutOfPages` (after
        evicting reclaimable prefix entries) when the pool is exhausted,
        leaving the table unchanged."""
        need = pages_for(tokens, self.page_size)
        if need > self.max_pages:
            raise MXNetError(
                f"request needs {need} pages but max_len allows only "
                f"{self.max_pages}")
        with self._lock:
            have = int(self._leased[slot])
            if need <= have:
                return 0
            fresh = self._alloc(need - have)
            self._tables[slot, have:need] = fresh
            self._leased[slot] = need
            return len(fresh)

    def release(self, slot: int):
        """Return every page the slot references (shared pages survive
        under their remaining refs)."""
        with self._lock:
            for i in range(int(self._leased[slot])):
                self._decref(int(self._tables[slot, i]))
            self._tables[slot, :] = self.sink
            self._leased[slot] = 0

    # ------------------------------------------------------------ copy-on-write
    def writable(self, slot: int, start: int, end: int
                 ) -> List[Tuple[int, int]]:
        """Pages the slot must fork before writing token positions
        ``[start, end)``: every mapped page in that range with refs > 1.
        Returns [(table_index, physical_page)]."""
        out = []
        lo = start // self.page_size
        hi = pages_for(end, self.page_size)
        with self._lock:
            for i in range(lo, min(hi, int(self._leased[slot]))):
                p = int(self._tables[slot, i])
                if p != self.sink and self._ref[p] > 1:
                    out.append((i, p))
        return out

    def fork(self, slot: int, table_index: int) -> Tuple[int, int]:
        """Copy-on-write bookkeeping for one shared page: lease a fresh
        page, point the slot's table at it, drop the shared ref. Returns
        (src_page, dst_page); the engine copies the rows."""
        with self._lock:
            src = int(self._tables[slot, table_index])
            dst = self._alloc(1)[0]
            self._tables[slot, table_index] = dst
            self._decref(src)
            self.cow_forks += 1
        _metrics.SERVE_PAGE_COW.inc()
        return src, dst

    # ------------------------------------------------------------ prefix cache
    @staticmethod
    def _hash(tokens: Tuple[int, ...]) -> int:
        """Chain key for a token prefix: sha1 over the raw int32 bytes
        (stable across processes)."""
        data = np.asarray(tokens, np.int32).tobytes()
        return int.from_bytes(hashlib.sha1(data).digest()[:8], "little")

    def match_prefix(self, tokens: Sequence[int], count: bool = True
                     ) -> Tuple[List[int], int]:
        """Longest cached prefix of ``tokens``: ([physical pages],
        matched_len), capped at ``len(tokens) - 1`` so at least one token
        goes through prefill. Collisions stop the walk. Takes no refs
        (``map_prefix`` does); ``count=False`` leaves the hit/miss counters
        alone."""
        if not self.prefix_cache_enabled:
            return [], 0
        toks = tuple(int(t) for t in tokens)
        cap = len(toks) - 1
        pages: List[int] = []
        matched = 0
        i = 0
        with self._lock:
            while i * self.page_size < cap:
                best: Optional[_PrefixEntry] = None
                # longest extension first (the full page, then shorter
                # partial tails), capped so one token stays unprefilled
                for ln in range(min(cap - i * self.page_size,
                                    self.page_size), 0, -1):
                    ent = self._lookup(toks, i * self.page_size + ln)
                    if ent is not None:
                        best = ent
                        break
                if best is None:
                    break
                pages.append(best.page)
                matched = best.prefix_len
                if len(best.chunk) < self.page_size:
                    break                  # partial tail page ends the walk
                i += 1
            if count:
                if matched:
                    self.prefix_hits += 1
                    self.prefix_tokens_saved += matched
                    _metrics.SERVE_PREFIX_HITS.inc()
                    _metrics.SERVE_PREFIX_TOKENS_SAVED.inc(matched)
                else:
                    self.prefix_misses += 1
                    _metrics.SERVE_PREFIX_MISSES.inc()
        return pages, matched

    def _lookup(self, toks: Tuple[int, ...], length: int
                ) -> Optional[_PrefixEntry]:
        if length > len(toks):
            return None
        key = self._hash(toks[:length])
        bucket = self._prefix.get(key)
        if bucket is None:
            return None
        page_index = (length - 1) // self.page_size
        lo = page_index * self.page_size
        for ent in bucket:
            if ent.prefix_len == length and ent.chunk == toks[lo:length]:
                self._prefix.move_to_end(key)          # LRU refresh
                return ent
        # key present but tokens differ: a hash collision; prefill this
        # span rather than serve another prompt's KV rows
        self.prefix_collisions += 1
        _metrics.SERVE_PREFIX_COLLISIONS.inc()
        return None

    def map_prefix(self, slot: int, pages: Sequence[int], matched: int):
        """Point the slot's table at the matched pages (one ref each). The
        caller prefills from ``matched`` on; a partial tail page forks on
        its first write (``writable``)."""
        with self._lock:
            for i, p in enumerate(pages):
                self._tables[slot, i] = p
                self._ref[p] += 1
            self._leased[slot] = len(pages)
            self._observe()

    def insert_prefix(self, slot: int, tokens: Sequence[int]):
        """Publish the slot's prompt pages into the prefix cache: one
        chained entry per page (full pages plus the partial tail); entries
        already present are skipped."""
        if not self.prefix_cache_enabled:
            return
        toks = tuple(int(t) for t in tokens)
        npages = pages_for(len(toks), self.page_size)
        with self._lock:
            for i in range(npages):
                length = min((i + 1) * self.page_size, len(toks))
                if self._lookup(toks, length) is not None:
                    continue
                page = int(self._tables[slot, i])
                if page == self.sink:
                    break
                chunk = toks[i * self.page_size:length]
                ent = _PrefixEntry(page=page, page_index=i, chunk=chunk,
                                   prefix_len=length)
                self._prefix.setdefault(self._hash(toks[:length]), []) \
                    .append(ent)
                self._ref[page] += 1
            self._observe()

    def prefix_summary(self, top_n: int) -> List[List[int]]:
        """Bounded advert of the cache's hottest roots for the router's
        prefix-affinity scoring: ``[[chain_key, prefix_len, refs], ...]``,
        the top ``top_n`` entries ranked by (page refcount, prefix length).
        A router holding a prompt checks ``prefix_key(prompt[:prefix_len])
        == chain_key``. ``top_n <= 0`` disables the advert (an empty
        list); the payload stays O(top_n) whatever the pool's size."""
        if top_n <= 0 or not self.prefix_cache_enabled:
            return []
        with self._lock:
            roots = [[int(key), int(ent.prefix_len), int(self._ref[ent.page])]
                     for key, bucket in self._prefix.items()
                     for ent in bucket]
        roots.sort(key=lambda r: (-r[2], -r[1], r[0]))
        return roots[:int(top_n)]

    def adopt_prefix(self, tokens: Sequence[int],
                     lengths: Sequence[int]) -> List[Tuple[int, int]]:
        """Migration import: allocate and publish prefix-cache entries for
        the chain positions ``lengths`` of ``tokens`` (each a prefix length
        ending a page chunk, ascending). Positions already cached are
        skipped, as :meth:`insert_prefix` skips them. Returns
        ``[(prefix_len, page)]`` for the fresh entries (each page held by
        its entry alone, one ref); the engine writes the shipped payload
        into each page. Allocation is all or nothing (:class:`OutOfPages`
        leaves the cache unchanged); it may evict older entries, earlier
        links of the same chain included, and the match walk then stops at
        the hole and the tail prefills again: slower, never wrong."""
        toks = tuple(int(t) for t in tokens)
        out: List[Tuple[int, int]] = []
        if not self.prefix_cache_enabled:
            return out
        with self._lock:
            fresh = [int(ln) for ln in lengths
                     if 0 < int(ln) <= len(toks) and self._lookup(toks, int(ln)) is None]
            pages = self._alloc(len(fresh))
            for ln, page in zip(fresh, pages):
                lo = ((ln - 1) // self.page_size) * self.page_size
                ent = _PrefixEntry(page=page, page_index=(ln - 1) // self.page_size,
                                   chunk=toks[lo:ln], prefix_len=ln)
                self._prefix.setdefault(self._hash(toks[:ln]), []).append(ent)
                out.append((ln, page))
            self._observe()
        return out

    def _evict_one(self) -> bool:
        """Drop the least-recently-used prefix entry; True if anything was
        evicted (cache-only pages return to the free list)."""
        if not self._prefix:
            return False
        key, bucket = next(iter(self._prefix.items()))
        ent = bucket.pop(0)
        if not bucket:
            del self._prefix[key]
        self._decref(ent.page)
        self.prefix_evictions += 1
        return True

    def clear_prefix_cache(self):
        with self._lock:
            while self._evict_one():
                pass

    # ------------------------------------------------------------ stats
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "page_size": self.page_size,
                "pages": self.num_pages,
                "pages_in_use": self.pages_in_use(),
                "pages_free": self.free_pages(),
                "pages_cached_only": self._cache_only_pages(),
                "leases": self.leases,
                "cow_forks": self.cow_forks,
                "prefix_entries": sum(len(b)
                                      for b in self._prefix.values()),
                "prefix_hits": self.prefix_hits,
                "prefix_misses": self.prefix_misses,
                "prefix_tokens_saved": self.prefix_tokens_saved,
                "prefix_collisions": self.prefix_collisions,
                "prefix_evictions": self.prefix_evictions,
            }
