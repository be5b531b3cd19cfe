"""Host-side page allocator: free list, refcounts (copy-on-write beam
forks), and LRU reuse of freed prefix-cache pages.

TPU-native redesign of the reference's page-table + LRU machinery
(``kv_cache/page_table.{hpp,cpp}``, ``kv_cache/kv_tile_cache.cpp:65-98``):
the (beam, head, tile)->page mapping collapses to per-sequence block
tables (pages hold all KV heads of a tile, so the head dimension drops
out), the device "sync" is an ordinary host->device array update folded
into the scheduler step, and — fixing the reference's semantics —
eviction never silently drops pages of *live* sequences (the reference's
``evict_if_needed`` drops the LRU tail even if in use and then reuses a
colliding page id, ``kv_tile_cache.cpp:71,90-98``). Here allocation
fails with :class:`OutOfPagesError` so the scheduler can preempt/queue,
and only *freed* pages are recycled (LRU order) — which also provides
prefix-cache reuse.

Single-threaded by design: owned by the scheduler (SURVEY.md §5.2).
"""

from __future__ import annotations

import ctypes
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple


def tag64(tag: object) -> int:
    """Canonical tag domain: a signed 64-bit digest. The JAX package's
    two allocators (its Python twin of this one and its C++
    ``csrc/page_allocator.cpp``) compare prefix-cache tags in this
    space; the port has the Python one only (the C++ one waits for ROADMAP
    queue A, scheduler). Callers must treat tags as content digests (hash
    equality), not identity objects."""
    h = tag if isinstance(tag, int) else hash(tag)
    return ctypes.c_int64(h).value


class OutOfPagesError(RuntimeError):
    """Pool exhausted — caller must preempt, queue, or evict."""


class PageAllocator:
    """Manages ``num_pages`` physical page slots.

    Pages are refcounted: beam forks share pages (``fork``) and a write
    to a shared page must first go through ``ensure_exclusive`` which
    hands back a private copy slot (the device-side copy is the
    caller's job; this class only tracks ownership).
    """

    #: page id 0 is never allocated: it is the hardware "dump" page that
    #: invalid writes (padding tokens, unused block-table slots) are
    #: redirected to, so they can never clobber a live page
    DUMP_PAGE = 0

    def __init__(self, num_pages: int):
        self.num_pages = num_pages
        self._free: List[int] = list(range(num_pages - 1, 0, -1))
        self._refs: Dict[int, int] = {}
        # freed-but-reusable pages keyed by content tag (prefix cache),
        # in LRU order: oldest first.
        self._lru: "OrderedDict[int, object]" = OrderedDict()

    # -- core ---------------------------------------------------------------
    @property
    def num_free(self) -> int:
        return len(self._free) + len(self._lru)

    @property
    def num_live(self) -> int:
        return len(self._refs)

    @property
    def num_cached(self) -> int:
        """Freed pages retained for prefix reuse (LRU)."""
        return len(self._lru)

    def claim(self, page: int) -> None:
        """Force-claim a specific page id (KV-snapshot restore): incref
        if live, else take it off the free/LRU lists with refcount 1."""
        if page in self._refs:
            self._refs[page] += 1
            return
        if page in self._lru:
            del self._lru[page]
        else:
            self._free.remove(page)
        self._refs[page] = 1

    def alloc(self) -> int:
        if self._free:
            page = self._free.pop()
        elif self._lru:
            page, _ = self._lru.popitem(last=False)  # evict oldest freed page
        else:
            raise OutOfPagesError(
                f"page pool exhausted ({self.num_pages} pages live)")
        self._refs[page] = 1
        return page

    def alloc_many(self, n: int) -> List[int]:
        if n > self.num_free:
            raise OutOfPagesError(
                f"need {n} pages, only {self.num_free} free")
        return [self.alloc() for _ in range(n)]

    def free(self, page: int, tag: Optional[object] = None) -> None:
        refs = self._refs.get(page)
        if refs is None:
            raise ValueError(f"double free of page {page}")
        if refs > 1:
            self._refs[page] = refs - 1
            return
        del self._refs[page]
        if tag is not None:
            self._lru[page] = tag64(tag)   # retained for prefix reuse
        else:
            self._free.append(page)

    def fork(self, pages: List[int]) -> List[int]:
        """Share pages with a new sequence (beam fork): incref, COW
        later. Validates every page before touching any refcount (same
        all-or-nothing error path as the C++ twin)."""
        for p in pages:
            if p not in self._refs:
                raise KeyError(f"fork of non-live page {p}")
        for p in pages:
            self._refs[p] += 1
        return list(pages)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def ensure_exclusive(self, page: int) -> Tuple[int, bool]:
        """Return a page safe to write.

        If ``page`` is exclusively owned, returns ``(page, False)``.
        Otherwise allocates a fresh page, decrefs the shared one, and
        returns ``(new_page, True)`` — the caller must copy the page
        contents on device (copy-on-write).
        """
        if self._refs[page] == 1:
            return page, False
        new_page = self.alloc()
        self._refs[page] -= 1
        return new_page, True

    def resize(self, new_num_pages: int) -> None:
        """Grow or shrink the managed page range (``KVTileCache::resize``
        capability). Shrinking requires every dropped page id to be
        free; live pages are never invalidated."""
        if new_num_pages > self.num_pages:
            self._free.extend(range(self.num_pages, new_num_pages))
        else:
            for p in range(new_num_pages, self.num_pages):
                if p in self._refs:
                    raise ValueError(
                        f"cannot shrink below live page {p}")
            for p in range(new_num_pages, self.num_pages):
                if p in self._lru:
                    del self._lru[p]
                else:
                    self._free.remove(p)
        self.num_pages = new_num_pages

    # -- prefix cache -------------------------------------------------------
    def drop_cached(self) -> int:
        """Invalidate the prefix cache: move every freed-but-tagged page
        to the plain free list. Used after a device-state reset (failed
        decode step reinitializes the pool) makes cached contents stale.
        Returns the number of pages dropped."""
        n = len(self._lru)
        self._free.extend(self._lru.keys())
        self._lru.clear()
        return n

    def lookup_freed(self, tag: object) -> Optional[int]:
        """Reclaim a freed page whose content tag matches (prefix cache)."""
        t64 = tag64(tag)
        for page, t in reversed(self._lru.items()):
            if t == t64:
                del self._lru[page]
                self._refs[page] = 1
                return page
        return None
