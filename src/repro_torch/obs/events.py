"""Typed fault-event stream: the host-side landing zone for detections.

``FaultReport`` holds a step's counters on the device.  This module is
where those counters *land* once a step has copied them to the host
(``repro_torch.core.policy.metrics_to_ints``, one copy a step): each
flagged op kind becomes one :class:`FaultEvent` carrying the op kind,
the step, the emitting subsystem, and (when the caller knows them) the
cell id, shard, bit band, detector value vs. bound, and the request ids
resident in the affected slots.

The :class:`EventBus` mirrors the FaultReport contract host-side: it is
a monoid (``EventBus.merged`` is associative with the empty bus as
identity, and ``counters()`` of a merged bus equals the elementwise sum
of the parts), events append in emission order and never reset, and the
JSONL export round-trips through :func:`validate_event` so downstream
consumers can treat the file as a schema'd stream rather than loose
dicts.  The wire format is the JAX package's: either package reads the
other's files.
"""
from __future__ import annotations

import dataclasses
import json
import math
from typing import Any, Dict, Iterable, Iterator, List, Optional, Tuple

#: bump when FaultEvent gains/renames REQUIRED fields.  v2 added the
#: monitor kinds ``alert`` / ``health``; v3 adds the adaptive-threshold
#: ``threshold`` kind (controller adjustments).  The wire format is
#: otherwise unchanged, so v1/v2 files (old committed artifacts) still
#: load.
EVENT_SCHEMA_VERSION = 3

#: the event taxonomy; ``validate_event`` rejects anything else
EVENT_KINDS = ("detection", "false_positive", "injection", "cell", "info",
               "alert", "health", "threshold")

#: required keys and their types in the JSONL wire format
EVENT_SCHEMA: Dict[str, tuple] = {
    "schema": (int,),
    "kind": (str,),
    "op": (str,),
    "step": (int,),
    "source": (str,),
    "t_s": (int, float),
    "errors": (int,),
    "checks": (int,),
    "cell_id": (str, type(None)),
    "shard": (int, type(None)),
    "bit_band": (str, type(None)),
    "detector_value": (int, float, type(None)),
    "bound": (int, float, type(None)),
    "request_ids": (list,),
    "attrs": (dict,),
}


@dataclasses.dataclass
class FaultEvent:
    """One observable fault-pipeline occurrence.

    ``op`` is a registered FaultReport op kind for detections
    (``qgemm`` / ``embedding_bag`` / ``kv_cache`` / ...); injection and
    cell-summary events use the injecting target's name.  ``request_ids``
    are the serving requests resident in the affected batcher slots when
    the flag fired — the per-request attribution the SLO lines consume.
    """
    op: str
    step: int
    source: str                              # e.g. "serving.engine"
    kind: str = "detection"
    t_s: float = 0.0
    errors: int = 0
    checks: int = 0
    cell_id: Optional[str] = None
    shard: Optional[int] = None
    bit_band: Optional[str] = None
    detector_value: Optional[float] = None   # what the detector measured
    bound: Optional[float] = None            # the threshold it compared to
    request_ids: Tuple[int, ...] = ()
    attrs: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["request_ids"] = list(self.request_ids)
        d["schema"] = EVENT_SCHEMA_VERSION
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "FaultEvent":
        d = dict(d)
        d.pop("schema", None)
        d["request_ids"] = tuple(d.get("request_ids") or ())
        return cls(**d)


def validate_event(d: dict) -> dict:
    """Validate one JSONL record against :data:`EVENT_SCHEMA`.

    Returns the record; raises ``ValueError`` naming every violation."""
    problems = []
    for key, types in EVENT_SCHEMA.items():
        if key not in d:
            problems.append(f"missing key {key!r}")
        elif not isinstance(d[key], types):
            problems.append(
                f"{key!r} has type {type(d[key]).__name__}, want one of "
                f"{[t.__name__ for t in types]}")
    if not problems:
        if d["kind"] not in EVENT_KINDS:
            problems.append(f"kind {d['kind']!r} not in {EVENT_KINDS}")
        if d["schema"] > EVENT_SCHEMA_VERSION:
            problems.append(f"schema {d['schema']} is newer than "
                            f"{EVENT_SCHEMA_VERSION}")
        if any(not isinstance(r, int) for r in d["request_ids"]):
            problems.append("request_ids must be a list of ints")
    if problems:
        raise ValueError(f"invalid FaultEvent: {'; '.join(problems)}")
    return d


class EventBus:
    """Append-only host-side sink for :class:`FaultEvent`s.

    Live consumers (the detection-health :class:`~repro_torch.obs.Monitor`,
    incremental flushing) attach via :meth:`subscribe`; subscribers see
    each event at emission time, in order.  Subscribers are wiring, not
    data: they are NOT part of the monoid (``merged`` and ``from_jsonl``
    return un-subscribed buses)."""

    def __init__(self, events: Optional[Iterable[FaultEvent]] = None):
        self.events: List[FaultEvent] = list(events or [])
        self._subscribers: List = []

    def subscribe(self, fn) -> None:
        """Call ``fn(event)`` synchronously on every subsequent emit.
        Idempotent per callable."""
        if fn not in self._subscribers:
            self._subscribers.append(fn)

    # ------------------------------ monoid ----------------------------------

    def emit(self, event: FaultEvent) -> FaultEvent:
        self.events.append(event)
        for fn in list(self._subscribers):
            fn(event)
        return event

    def extend(self, events: Iterable[FaultEvent]) -> None:
        for ev in events:
            self.emit(ev)

    @classmethod
    def merged(cls, *buses: "EventBus") -> "EventBus":
        """Order-preserving concatenation — the host-side analogue of
        ``merge_reports`` (associative; the empty bus is the identity)."""
        out = cls()
        for b in buses:
            out.events.extend(b.events)
        return out

    def counters(self) -> Dict[str, int]:
        """Per-op error totals over the stream — comparable 1:1 with a
        merged FaultReport's ``errors`` dict for detection events."""
        out: Dict[str, int] = {}
        for ev in self.events:
            if ev.kind in ("detection", "false_positive"):
                out[ev.op] = out.get(ev.op, 0) + int(ev.errors)
        return out

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[FaultEvent]:
        return iter(self.events)

    # ------------------------------ JSONL -----------------------------------

    def to_jsonl(self, path: str) -> str:
        with open(path, "w") as f:
            for ev in self.events:
                f.write(json.dumps(ev.to_dict(), sort_keys=True) + "\n")
        return path

    @classmethod
    def from_jsonl(cls, path: str) -> "EventBus":
        """Load an exported stream; reads any schema <= the current
        version (v1 files predate the ``alert``/``health`` kinds, v2
        files predate ``threshold``, but are otherwise identical).
        Invalid records raise ``ValueError`` naming the offending
        ``path:line``."""
        bus = cls()
        with open(path) as f:
            for ln, line in enumerate(f, start=1):
                line = line.strip()
                if not line:
                    continue
                try:
                    bus.emit(FaultEvent.from_dict(
                        validate_event(json.loads(line))))
                except (ValueError, TypeError, KeyError) as e:
                    raise ValueError(f"{path}:{ln}: {e}") from e
        return bus


def op_counts(metrics: dict) -> List[Tuple[str, int, int]]:
    """``(op, checks, errors)`` per detection channel in a step's metrics.

    Accepts both metric spellings in circulation — the protect-layer
    ``abft/<kind>_*`` keys and the serving StepEvent's bare
    ``<kind>_*`` counters — with the JAX train loop's dedup rule:
    the legacy aggregate aliases (``abft/gemm_*`` = int8 + float GEMMs,
    ``abft/eb_*``) are consulted only when NO keyed counter is present,
    so a ``FaultReport.as_metrics()`` dict (which carries both) never
    double-counts.  The ``comm/errors`` checked_psum channel rides
    along as its own op.  Counts are ceiled: grad-accum averaging can
    make a detection arrive fractional (0.25 with accum=4), and
    truncation would silently drop it."""
    from repro_torch.core.policy import op_kinds

    ceil = lambda v: int(math.ceil(float(v)))  # noqa: E731
    out: List[Tuple[str, int, int]] = []
    keyed = False
    for op in op_kinds():
        for prefix in (f"abft/{op}_", f"{op}_"):
            if f"{prefix}errors" in metrics or f"{prefix}checks" in metrics:
                keyed = True
                out.append((op, ceil(metrics.get(f"{prefix}checks", 0)),
                            ceil(metrics.get(f"{prefix}errors", 0))))
                break
    if not keyed:
        for alias, op in (("abft/gemm", "gemm"),
                          ("abft/eb", "embedding_bag")):
            if f"{alias}_errors" in metrics:
                out.append((op, ceil(metrics.get(f"{alias}_checks", 0)),
                            ceil(metrics[f"{alias}_errors"])))
    if "comm/errors" in metrics:
        out.append(("comm", ceil(metrics.get("comm/checks", 0)),
                    ceil(metrics["comm/errors"])))
    return out


def events_from_metrics(metrics: dict, *, step: int, source: str,
                        t_s: float = 0.0, kind: str = "detection",
                        cell_id: Optional[str] = None,
                        shard: Optional[int] = None,
                        bit_band: Optional[str] = None,
                        request_ids: Tuple[int, ...] = (),
                        ) -> List[FaultEvent]:
    """One :class:`FaultEvent` per detection channel with errors this
    step (see :func:`op_counts` for the spelling/dedup rules)."""
    return [FaultEvent(
        op=op, step=step, source=source, kind=kind, t_s=t_s,
        errors=errors, checks=checks, cell_id=cell_id,
        shard=shard, bit_band=bit_band,
        request_ids=tuple(request_ids))
        for op, checks, errors in op_counts(metrics) if errors > 0]


__all__ = ["FaultEvent", "EventBus", "events_from_metrics", "op_counts",
           "validate_event", "EVENT_SCHEMA", "EVENT_SCHEMA_VERSION",
           "EVENT_KINDS"]
