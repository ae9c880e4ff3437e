"""Timed spans with Chrome/Perfetto trace export.

A :class:`Tracer` collects named wall-clock spans — the campaign
executor's build/trials/clean/overhead phases, the serving engine's
prefill/decode steps, a target's encode/compute/verify breakdown — and
serializes them as Chrome Trace Event JSON (``"ph": "X"`` complete
events), which both ``chrome://tracing`` and https://ui.perfetto.dev
open directly.  Track assignment: ``pid`` 0, one ``tid`` per category,
so campaign phases and serving steps land on separate rows.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Span:
    name: str
    cat: str
    start_s: float              # seconds since the tracer's epoch
    dur_s: float
    args: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class Tracer:
    def __init__(self, clock=time.perf_counter):
        self._clock = clock
        self._epoch = clock()
        self.spans: List[Span] = []

    def now_s(self) -> float:
        return self._clock() - self._epoch

    @contextlib.contextmanager
    def span(self, name: str, cat: str = "phase", **args):
        """Time a ``with`` block as one span."""
        t0 = self.now_s()
        try:
            yield self
        finally:
            self.add_span(name, cat=cat, start_s=t0,
                          dur_s=self.now_s() - t0, **args)

    def add_span(self, name: str, *, cat: str = "phase", start_s: float,
                 dur_s: float, **args) -> Span:
        """Record an externally-timed span (e.g. the serving engine's
        measured step durations on its hybrid clock)."""
        span = Span(name=name, cat=cat, start_s=float(start_s),
                    dur_s=float(max(0.0, dur_s)), args=dict(args))
        self.spans.append(span)
        return span

    # ------------------------------ export ----------------------------------

    def to_chrome_trace(self) -> dict:
        """Chrome Trace Event format (Perfetto-compatible), one complete
        ("ph": "X") event per span, microsecond timestamps."""
        cats = {}
        events = []
        for s in self.spans:
            tid = cats.setdefault(s.cat, len(cats))
            events.append({
                "name": s.name, "cat": s.cat, "ph": "X",
                "ts": round(s.start_s * 1e6, 3),
                "dur": round(s.dur_s * 1e6, 3),
                "pid": 0, "tid": tid, "args": s.args,
            })
        meta = [{"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
                 "args": {"name": cat}} for cat, tid in cats.items()]
        return {"traceEvents": meta + events, "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)
        return path

    def total_s(self, cat: Optional[str] = None) -> float:
        return sum(s.dur_s for s in self.spans
                   if cat is None or s.cat == cat)

    def __len__(self) -> int:
        return len(self.spans)


__all__ = ["Span", "Tracer"]
