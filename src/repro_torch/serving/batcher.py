"""Continuous batcher: fixed-slot decode batch with mid-stream admission.

The decode batch has ``n_slots`` fixed positions (the jitted decode step
is compiled once per lane at that width).  A finished request retires its
slot immediately; the next engine iteration admits the oldest queued
request into the free slot and prefills it while the other slots keep
decoding — classic continuous batching, host-side bookkeeping only (the
engine owns the jax-side cache/pos/token arrays this mirrors).

Invariants (pinned by tests/test_serving_batcher.py):

* ``len(free) + len(active) == n_slots`` after every operation — no slot
  leaks, no double-occupancy;
* admission order == arrival order among a lane's requests (FIFO under
  burst);
* a slot's request is returned exactly once by :meth:`retire`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.serving.queue import AdmissionQueue
from repro_torch.serving.workload import Request


@dataclasses.dataclass
class Slot:
    """One occupied decode-batch position."""
    index: int
    request: Request
    admit_s: float
    pos: int = 0                    # absolute decode position (incl. prefix)
    generated: int = 0
    first_token_s: Optional[float] = None
    queue_wait_s: float = 0.0
    #: prompt tokens this admission actually prefilled/quantized (the
    #: engine refines it post-prefill: the contiguous path pays the full
    #: bucket, the paged path only the non-shared pages) and the tokens
    #: served from shared prefix pages instead
    prefill_tokens: int = 0
    shared_prefix_tokens: int = 0


class ContinuousBatcher:
    def __init__(self, n_slots: int):
        if n_slots < 1:
            raise ValueError("n_slots must be >= 1")
        self.n_slots = n_slots
        self._free: List[int] = list(range(n_slots))
        self._active: Dict[int, Slot] = {}

    # ------------------------------ queries ---------------------------------

    def free_count(self) -> int:
        return len(self._free)

    def active_slots(self) -> List[Slot]:
        return [self._active[i] for i in sorted(self._active)]

    def occupancy(self) -> int:
        return len(self._active)

    def check_invariants(self) -> None:
        assert len(self._free) + len(self._active) == self.n_slots, \
            (self._free, sorted(self._active))
        assert not (set(self._free) & set(self._active)), \
            (self._free, sorted(self._active))
        assert len(set(self._free)) == len(self._free), self._free

    # ------------------------------ transitions -----------------------------

    def admit(self, queue: AdmissionQueue, clock_s: float,
              accept=None) -> List[Slot]:
        """Fill free slots from the queue (FIFO among accepted requests)."""
        admitted: List[Slot] = []
        while self._free:
            item = queue.pop_next(accept)
            if item is None:
                break
            req, enq_s = item
            idx = self._free.pop(0)
            slot = Slot(index=idx, request=req, admit_s=clock_s,
                        queue_wait_s=max(0.0, clock_s - enq_s),
                        prefill_tokens=req.prompt_len)
            self._active[idx] = slot
            admitted.append(slot)
        self.check_invariants()
        return admitted

    def retire(self, index: int) -> Slot:
        if index not in self._active:
            raise KeyError(f"slot {index} is not active")
        slot = self._active.pop(index)
        self._free.append(index)
        self.check_invariants()
        return slot

    def retire_finished(self) -> List[Slot]:
        done = [i for i, s in self._active.items()
                if s.generated >= s.request.max_new_tokens]
        return [self.retire(i) for i in sorted(done)]

    def drain(self) -> List[Slot]:
        """Retire everything (lane reset after an abort)."""
        return [self.retire(i) for i in sorted(self._active)]


__all__ = ["ContinuousBatcher", "Slot"]
