"""Prefix tree over token chunks -> resident page ids (host-side).

Each node owns one page-sized token chunk; a path from the root spells a
prompt prefix, so two requests share pages exactly when their token
streams agree chunk-for-chunk from position 0.  Sharing is
copy-on-write at page granularity: shared pages are immutable (decode
appends always land in private tail pages the engine allocates outside
the tree), and the tree itself holds one allocator reference per node so
a popular system prompt stays quantized+checksummed in the pool across
request lifetimes.

Eviction is by detaching nodes: ``evict_page`` removes a corrupted
page's node *and its subtree* (descendants are only reachable through
the corrupt prefix), dropping the tree's references; ``evict_lru`` frees
cold leaves when the allocator runs dry.  Active requests keep their own
allocator references, so a detached page is recycled only once its last
reader retires.

The JAX package's ``paging/prefixtree.py``, host code, copied as it is.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple


class _Node:
    __slots__ = ("key", "page_id", "children", "parent", "last_use")

    def __init__(self, key: bytes, page_id: int, parent: "Optional[_Node]"):
        self.key = key
        self.page_id = page_id
        self.children: Dict[bytes, _Node] = {}
        self.parent = parent
        self.last_use = 0


class PrefixTree:
    def __init__(self):
        self._root = _Node(b"", -1, None)
        self._by_page: Dict[int, _Node] = {}
        self._clock = 0

    def __len__(self) -> int:
        return len(self._by_page)

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    def match(self, chunk_keys: Sequence[bytes]) -> List[_Node]:
        """Longest chain of consecutive chunk matches from the root."""
        t = self._tick()
        out: List[_Node] = []
        node = self._root
        for key in chunk_keys:
            child = node.children.get(key)
            if child is None:
                break
            child.last_use = t
            out.append(child)
            node = child
        return out

    def insert(self, parent: Optional[_Node], key: bytes,
               page_id: int) -> _Node:
        """Register ``page_id`` as the chunk ``key`` under ``parent``
        (None = root).  The caller transfers one allocator reference to
        the tree."""
        parent = parent or self._root
        node = _Node(key, page_id, parent)
        node.last_use = self._tick()
        parent.children[key] = node
        self._by_page[page_id] = node
        return node

    def _detach(self, node: _Node) -> List[int]:
        """Remove ``node`` and its subtree; returns the page ids whose
        tree references the caller must release."""
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        node.parent = None
        freed: List[int] = []
        stack = [node]
        while stack:
            n = stack.pop()
            self._by_page.pop(n.page_id, None)
            freed.append(n.page_id)
            stack.extend(n.children.values())
            n.children.clear()
        return freed

    def evict_page(self, page_id: int) -> List[int]:
        """Evict a (corrupted) page and everything reachable only
        through it.  No-op (empty list) if the page isn't tree-owned."""
        node = self._by_page.get(page_id)
        return self._detach(node) if node is not None else []

    def evict_lru(self) -> Optional[int]:
        """Detach the least-recently-used leaf; returns its page id (the
        caller releases the tree's reference) or None if the tree is
        empty."""
        leaf: Optional[_Node] = None
        for node in self._by_page.values():
            if node.children:
                continue
            if leaf is None or node.last_use < leaf.last_use:
                leaf = node
        if leaf is None:
            return None
        self._detach(leaf)
        return leaf.page_id

    def reset(self) -> None:
        self._root = _Node(b"", -1, None)
        self._by_page.clear()
        self._clock = 0


def chunk_keys(tokens, page_size: int) -> Tuple[bytes, ...]:
    """Split a (padded) prompt into page-sized chunk keys.  Only whole
    chunks are shareable; callers pad prompts to a page multiple first."""
    import numpy as np

    t = np.asarray(tokens, np.int32)
    n = (t.shape[0] // page_size) * page_size
    return tuple(t[i:i + page_size].tobytes()
                 for i in range(0, n, page_size))
