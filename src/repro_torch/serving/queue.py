"""Admission queue: bounded FIFO between the arrival process and the
continuous batcher.

The queue is strictly FIFO *per admissible set* — ``pop_next(accept)``
returns the oldest request the caller can currently place, so two plan
lanes draining one queue each preserve arrival order within their own
traffic, and a burst can never reorder a tenant's requests (the batcher
invariant tests pin this down).  A full queue rejects at ``push`` — the
load-shedding counter feeds the SLO telemetry, not an exception.
"""
from __future__ import annotations

from collections import deque
from typing import Callable, Dict, List, Optional

from repro_torch.serving.workload import Request


class AdmissionQueue:
    def __init__(self, max_depth: int = 0):
        """``max_depth=0`` means unbounded."""
        self.max_depth = max_depth
        self._q: deque = deque()       # (request, enqueue_clock_s)
        self.rejected: Dict[str, int] = {}
        self.admitted: Dict[str, int] = {}

    # ------------------------------ producer --------------------------------

    def push(self, req: Request, clock_s: float) -> bool:
        """Enqueue; returns False (and counts the rejection) when full."""
        if self.max_depth and len(self._q) >= self.max_depth:
            self.rejected[req.tenant] = self.rejected.get(req.tenant, 0) + 1
            return False
        self._q.append((req, clock_s))
        return True

    # ------------------------------ consumer --------------------------------

    def pop_next(self, accept: Optional[Callable[[Request], bool]] = None
                 ) -> Optional[tuple]:
        """Oldest request with ``accept(req)`` (default: any).  Returns
        ``(request, enqueue_clock_s)`` or None.  FIFO among the accepted
        subset; non-accepted requests keep their positions."""
        for i, (req, t) in enumerate(self._q):
            if accept is None or accept(req):
                del self._q[i]
                self.admitted[req.tenant] = \
                    self.admitted.get(req.tenant, 0) + 1
                return req, t
        return None

    # ------------------------------ telemetry -------------------------------

    def depth(self) -> int:
        return len(self._q)

    def tenant_depths(self) -> Dict[str, int]:
        d: Dict[str, int] = {}
        for req, _ in self._q:
            d[req.tenant] = d.get(req.tenant, 0) + 1
        return d

    def peek_all(self) -> List[Request]:
        return [req for req, _ in self._q]

    def __len__(self) -> int:
        return len(self._q)

    def __bool__(self) -> bool:
        return bool(self._q)


__all__ = ["AdmissionQueue"]
