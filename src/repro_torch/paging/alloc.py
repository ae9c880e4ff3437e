"""Free-list page allocator with refcounts (host-side).

Pages are plain integers into the device pools; the allocator never
touches device memory.  Refcounts let the prefix tree and any number of
resident requests share a page: the page returns to the free list only
when the last holder releases it.  ``high_water`` is the peak
simultaneously-allocated page count — multiplied by the per-page byte
cost it is the "peak resident KV bytes" the campaign compares against
the fixed-slot contiguous layout.

The JAX package's ``paging/alloc.py``, host code, copied as it is.
"""
from __future__ import annotations

from typing import Dict, List, Optional


class PageAllocator:
    def __init__(self, n_pages: int):
        if n_pages <= 0:
            raise ValueError("n_pages must be positive")
        self.n_pages = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._ref: Dict[int, int] = {}
        self.high_water = 0

    def alloc(self) -> Optional[int]:
        """One page at refcount 1, or None when the pool is exhausted."""
        if not self._free:
            return None
        pid = self._free.pop()
        self._ref[pid] = 1
        self.high_water = max(self.high_water, len(self._ref))
        return pid

    def retain(self, pid: int) -> None:
        self._ref[pid] += 1

    def release(self, pid: int) -> bool:
        """Drop one reference; True iff the page went back to the free
        list."""
        n = self._ref[pid] - 1
        if n:
            self._ref[pid] = n
            return False
        del self._ref[pid]
        self._free.append(pid)
        return True

    def refcount(self, pid: int) -> int:
        return self._ref.get(pid, 0)

    @property
    def used(self) -> int:
        return len(self._ref)

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def shared_count(self) -> int:
        """Pages held by more than one owner (tree + >=1 request, or
        several requests)."""
        return sum(1 for n in self._ref.values() if n > 1)

    def reset(self) -> None:
        self._free = list(range(self.n_pages - 1, -1, -1))
        self._ref.clear()
        self.high_water = 0
