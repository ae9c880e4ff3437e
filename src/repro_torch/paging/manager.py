"""Host-side paging manager: allocator + prefix tree + slot page tables.

The serving engine owns one :class:`PagedKVManager` per paged lane.  All
decisions that need host control flow live here — page allocation,
prefix-tree lookup at admission, LRU eviction under memory pressure,
corrupted-page eviction, retire-time release — while the device only
ever sees the resulting int32 table and fixed-shape scatter ids.

Reference protocol: a tree-owned page carries one reference from the
tree plus one per resident request mapping it; a decode-tail page (never
shared) carries only its owner's reference.  ``admit`` is transactional:
if the pool is exhausted mid-admission (even after LRU eviction), every
reference the call took is rolled back and ``AdmitPlan.ok`` is False.

The JAX package's ``paging/manager.py``, host code; only its imports
differ.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np

from repro_torch.paging.alloc import PageAllocator
from repro_torch.paging.prefixtree import PrefixTree, chunk_keys


@dataclasses.dataclass(frozen=True)
class PagingConfig:
    """Paged-KV knobs for the serving engine.

    ``page_size`` trades checksum granularity (bigger pages = fewer
    compares but a bigger blast radius and coarser sharing) against
    table overhead; ``n_pages`` sizes the pool shared by every slot in
    the lane."""
    page_size: int = 16
    n_pages: int = 256

    def to_dict(self):
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AdmitPlan:
    """Result of an admission-time prefix lookup + allocation."""
    ok: bool
    bucket: int = 0
    page_ids: Optional[np.ndarray] = None   # [bucket // P]; sentinel = skip
    shared_pages: int = 0
    new_pages: int = 0

    def tokens(self, page_size: int):
        """(prefill_tokens actually quantized, tokens served from shared
        pages) — what telemetry attributes to this admission."""
        return self.new_pages * page_size, self.shared_pages * page_size


class PagedKVManager:
    def __init__(self, cfg: PagingConfig, n_slots: int,
                 max_pages_per_slot: int):
        self.cfg = cfg
        self.n_slots = n_slots
        self.max_pages = max_pages_per_slot
        self.alloc = PageAllocator(cfg.n_pages)
        self.tree = PrefixTree()
        self.table = np.full((n_slots, max_pages_per_slot), -1, np.int32)
        self._prompt_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self._tail_pages: List[List[int]] = [[] for _ in range(n_slots)]
        self.prompt_chunks = [0] * n_slots
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.evictions = 0
        self.rebuilds = 0

    # -- admission -------------------------------------------------------

    def _alloc_or_evict(self) -> Optional[int]:
        pid = self.alloc.alloc()
        while pid is None:
            victim = self.tree.evict_lru()
            if victim is None:
                return None
            self.alloc.release(victim)
            self.evictions += 1
            pid = self.alloc.alloc()
        return pid

    def admit(self, slot: int, tokens: np.ndarray) -> AdmitPlan:
        """Map a padded prompt (len multiple of page_size) onto pages.

        Shared prefix chunks are served from the tree (no write needed);
        the rest get fresh pages and are registered for future sharers.
        """
        p = self.cfg.page_size
        keys = chunk_keys(tokens, p)
        if len(keys) > self.max_pages:
            return AdmitPlan(ok=False)
        nodes = self.tree.match(keys)
        shared = [n.page_id for n in nodes]
        for pid in shared:
            self.alloc.retain(pid)
        new_ids: List[int] = []
        parent = nodes[-1] if nodes else None
        for key in keys[len(nodes):]:
            pid = self._alloc_or_evict()
            if pid is None:
                for s in shared:
                    self.alloc.release(s)
                for n in new_ids:
                    # evict_page returns the tree refs still held (it may
                    # come back empty: under extreme pressure the LRU
                    # loop above can have detached a page we inserted
                    # earlier in this very call)
                    for freed in self.tree.evict_page(n):
                        self.alloc.release(freed)       # tree refs
                    self.alloc.release(n)               # request ref
                return AdmitPlan(ok=False)
            parent = self.tree.insert(parent, key, pid)  # tree takes alloc ref
            self.alloc.retain(pid)                       # request ref
            new_ids.append(pid)
        ordered = shared + new_ids
        self.table[slot, :] = -1
        self.table[slot, :len(ordered)] = ordered
        self._prompt_pages[slot] = ordered
        self._tail_pages[slot] = []
        self.prompt_chunks[slot] = len(ordered)
        self.prefix_hits += len(shared)
        self.prefix_misses += len(new_ids)
        sentinel = self.cfg.n_pages
        page_ids = np.full(len(keys), sentinel, np.int32)
        page_ids[len(shared):] = new_ids
        return AdmitPlan(ok=True, bucket=len(keys) * p, page_ids=page_ids,
                         shared_pages=len(shared), new_pages=len(new_ids))

    # -- decode ----------------------------------------------------------

    def decode_page(self, slot: int, chunk: int) -> Optional[int]:
        """Private tail page for the next decode block; None = pool full
        (the engine aborts the request)."""
        pid = self._alloc_or_evict()
        if pid is None:
            return None
        self.table[slot, chunk] = pid
        self._tail_pages[slot].append(pid)
        return pid

    # -- lifecycle -------------------------------------------------------

    def retire(self, slot: int) -> None:
        for pid in self._prompt_pages[slot]:
            self.alloc.release(pid)      # tree keeps its ref: page stays warm
        for pid in self._tail_pages[slot]:
            self.alloc.release(pid)
        self.table[slot, :] = -1
        self._prompt_pages[slot] = []
        self._tail_pages[slot] = []
        self.prompt_chunks[slot] = 0

    def release_prompt(self, slot: int) -> None:
        """Drop the slot's prompt mappings (rebuild path) but keep its
        decode-tail pages — generated KV survives the rebuild."""
        for pid in self._prompt_pages[slot]:
            self.alloc.release(pid)
        self.table[slot, :self.prompt_chunks[slot]] = -1
        self._prompt_pages[slot] = []

    def readmit(self, slot: int, tokens: np.ndarray) -> AdmitPlan:
        """Re-map a slot's prompt after eviction, preserving tail pages.

        ``admit`` wipes the whole table row; restore the tail mappings
        after it runs."""
        tail = list(self._tail_pages[slot])
        n_prompt = len(chunk_keys(tokens, self.cfg.page_size))
        plan = self.admit(slot, tokens)
        if plan.ok:
            self.rebuilds += 1
            for i, pid in enumerate(tail):
                self.table[slot, n_prompt + i] = pid
            self._tail_pages[slot] = tail
        return plan

    def evict_corrupt(self, slot: int, chunk: int) -> bool:
        """Evict the page under (slot, chunk) from the prefix tree (plus
        any descendants).  True if it was a prompt page (rebuildable);
        False means a private tail page — the owner must abort."""
        pid = int(self.table[slot, chunk])
        if pid < 0:
            return True
        if chunk >= self.prompt_chunks[slot]:
            return False
        for freed in self.tree.evict_page(pid):
            self.alloc.release(freed)
            self.evictions += 1
        return True

    def reset(self) -> None:
        self.alloc.reset()
        self.tree.reset()
        self.table[:] = -1
        self._prompt_pages = [[] for _ in range(self.n_slots)]
        self._tail_pages = [[] for _ in range(self.n_slots)]
        self.prompt_chunks = [0] * self.n_slots
        self.prefix_hits = 0
        self.prefix_misses = 0
        self.evictions = 0
        self.rebuilds = 0

    # -- stats -----------------------------------------------------------

    @property
    def prefix_hit_rate(self) -> float:
        total = self.prefix_hits + self.prefix_misses
        return self.prefix_hits / total if total else 0.0

    def stats(self) -> dict:
        return {
            "pages_resident": self.alloc.used,
            "pages_free": self.alloc.free_count,
            "pages_shared": self.alloc.shared_count,
            "pages_high_water": self.alloc.high_water,
            "prefix_hits": self.prefix_hits,
            "prefix_misses": self.prefix_misses,
            "prefix_hit_rate": self.prefix_hit_rate,
            "page_evictions": self.evictions,
            "page_rebuilds": self.rebuilds,
        }
