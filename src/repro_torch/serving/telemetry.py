"""Serving telemetry: SLO metrics merged with op-keyed fault counters.

One timeline owns both stories.  Every engine step appends a
:class:`StepEvent` — wall duration, batch occupancy, queue depth, and the
step's :class:`~repro_torch.core.policy.FaultReport` counters — and every
finished request appends a :class:`RequestRecord`.  Because ABFT counters
and latency samples share the clock, a mid-traffic bit flip shows up in
the same timeline as its cost: the detection spike, the recompute retries,
and the TTFT/per-token-latency degradation of the requests in flight.

``summary()`` rolls the timeline up into per-tenant SLO percentiles
(p50/p95/p99 TTFT, per-token latency, end-to-end latency), throughput,
queue-depth stats, per-op fault counters, and per-injection detection
outcome + latency.  ``to_dict()`` is the JSON artifact the soak campaign
and the serve CLI write.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np

PCTS = (50.0, 95.0, 99.0)

#: bump when to_dict() gains/renames fields — the serve CLI --json output
#: and the soak artifacts carry this so downstream parsers can dispatch
#: (v2: per-request/per-tenant prefill_tokens + shared_prefix_tokens)
TELEMETRY_SCHEMA_VERSION = 2


def percentiles_ms(xs_s: List[float]) -> Dict[str, float]:
    """{"p50": ..., "p95": ..., "p99": ..., "n": ...} in milliseconds.

    NaN-free by construction: non-finite samples are dropped, an empty
    stream returns explicit zeros (with ``n = 0`` so "no samples" stays
    distinguishable from "zero latency"), and a single sample is every
    percentile of itself — no reliance on np/list degenerate behavior."""
    xs = [float(x) for x in xs_s
          if x is not None and math.isfinite(float(x))]
    if not xs:
        return {**{f"p{int(p)}": 0.0 for p in PCTS}, "n": 0}
    if len(xs) == 1:
        v = xs[0] * 1e3
        return {**{f"p{int(p)}": v for p in PCTS}, "n": 1}
    arr = np.asarray(xs, np.float64) * 1e3
    out = {f"p{int(p)}": float(np.percentile(arr, p)) for p in PCTS}
    out["n"] = len(xs)
    return out


@dataclasses.dataclass
class RequestRecord:
    rid: int
    tenant: str
    kind: str
    arrival_s: float
    admit_s: float
    first_token_s: Optional[float]
    finish_s: float
    prompt_len: int
    tokens_out: int
    queue_wait_s: float
    aborted: bool = False
    rejected: bool = False               # shed at the admission queue
    tokens: Optional[List[int]] = None   # emitted ids (soak ground truth)
    #: prompt tokens this admission actually quantized at prefill vs
    #: served from already-resident shared prefix pages (paged KV lanes;
    #: contiguous lanes report the full bucket and zero shared)
    prefill_tokens: int = 0
    shared_prefix_tokens: int = 0
    #: flagged steps this request was resident in a slot for (attribution
    #: runs in finalize — a fault blames the requests it touched, not
    #: just the step)
    detections: int = 0
    suspect: bool = False                # detections > 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return self.first_token_s - self.arrival_s

    @property
    def e2e_s(self) -> float:
        return self.finish_s - self.arrival_s

    @property
    def per_token_s(self) -> Optional[float]:
        if self.first_token_s is None or self.tokens_out <= 1:
            return None
        return ((self.finish_s - self.first_token_s)
                / (self.tokens_out - 1))

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("tokens")                  # bulky; kept host-side only
        return d


@dataclasses.dataclass
class StepEvent:
    step: int
    t_s: float                           # clock at step end
    kind: str                            # prefill | decode | dlrm
    lane: str
    duration_s: float
    occupancy: int
    queue_depth: int
    counters: Dict[str, int]             # abft/<op>_{checks,errors}, ...
    errors: int                          # total residual errors this step
    injected: bool = False
    #: request ids resident in the step's batcher slots when it ran —
    #: the attribution join key (prefill: the admitted request; decode:
    #: every active slot; abort: the drained slots)
    slot_rids: Tuple[int, ...] = ()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class InjectionRecord:
    step: int
    victim: str
    clock_s: float
    persistent: bool = False
    detected: bool = False
    detect_step: Optional[int] = None
    latency_steps: Optional[int] = None
    latency_s: Optional[float] = None
    #: requests resident in slots at the detecting step
    attributed_rids: Tuple[int, ...] = ()

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["attributed_rids"] = list(self.attributed_rids)
        return d


class Telemetry:
    """Collects the request/step/injection timeline for one engine run."""

    def __init__(self):
        self.requests: List[RequestRecord] = []
        self.steps: List[StepEvent] = []
        self.injections: List[InjectionRecord] = []
        #: detection-health monitor summary (alerts, health states,
        #: transitions) — set by ServingEngine.run(monitor=...)
        self.monitor: Optional[dict] = None
        #: adaptive-threshold controller summaries (per (op, tenant):
        #: final rel_bound, adjustments, convergence) — set by
        #: ServingEngine.run(adapt=...)
        self.thresholds: Optional[list] = None

    # ------------------------------ recording -------------------------------

    def add_request(self, rec: RequestRecord) -> None:
        self.requests.append(rec)

    def add_step(self, ev: StepEvent) -> None:
        self.steps.append(ev)

    def add_injection(self, rec: InjectionRecord) -> None:
        self.injections.append(rec)

    # ------------------------------ analysis --------------------------------

    def finalize_injections(self) -> None:
        """Attribute each injection to the first flagged step at-or-after
        it (the engine's detect→act policies run online; this records how
        long the flag took in steps and wall seconds)."""
        for inj in self.injections:
            for ev in self.steps:
                if ev.step < inj.step or ev.errors <= 0:
                    continue
                inj.detected = True
                inj.detect_step = ev.step
                inj.latency_steps = ev.step - inj.step
                inj.latency_s = ev.t_s - inj.clock_s
                inj.attributed_rids = tuple(ev.slot_rids)
                break
        self.attribute_detections()

    def attribute_detections(self) -> None:
        """Blame flagged steps on the requests resident in their slots:
        every request whose rid appears in a flagged step's ``slot_rids``
        gains a detection count and the ``suspect`` bit.  Idempotent —
        recomputed from the timeline on every call."""
        by_rid = {r.rid: r for r in self.requests}
        for rec in by_rid.values():
            rec.detections = 0
            rec.suspect = False
        for ev in self.steps:
            if ev.errors <= 0:
                continue
            for rid in ev.slot_rids:
                rec = by_rid.get(rid)
                if rec is not None:
                    rec.detections += 1
                    rec.suspect = True

    def fault_counters(self) -> Dict[str, int]:
        total: Dict[str, int] = {}
        for ev in self.steps:
            for k, v in ev.counters.items():
                total[k] = total.get(k, 0) + int(v)
        return total

    def detection_steps(self) -> List[int]:
        return [ev.step for ev in self.steps if ev.errors > 0]

    def _tenant_summary(self, recs: List[RequestRecord]) -> dict:
        served = [r for r in recs if not r.rejected]
        ttft = [r.ttft_s for r in served if r.ttft_s is not None]
        ptl = [r.per_token_s for r in served if r.per_token_s is not None]
        return {
            "requests": len(recs),
            "completed": sum(1 for r in served if not r.aborted),
            "aborted": sum(1 for r in served if r.aborted),
            "rejected": sum(1 for r in recs if r.rejected),
            "tokens_out": sum(r.tokens_out for r in recs),
            "prefill_tokens": sum(r.prefill_tokens for r in served),
            "shared_prefix_tokens": sum(
                r.shared_prefix_tokens for r in served),
            "suspect": sum(1 for r in served if r.suspect),
            "detections": sum(r.detections for r in served),
            "ttft_ms": percentiles_ms(ttft),
            "per_token_ms": percentiles_ms(ptl),
            "e2e_ms": percentiles_ms([r.e2e_s for r in served]),
            "queue_wait_ms": percentiles_ms(
                [r.queue_wait_s for r in served]),
        }

    def summary(self) -> dict:
        self.finalize_injections()
        tenants = sorted({r.tenant for r in self.requests})
        span = max((ev.t_s for ev in self.steps), default=0.0)
        depths = [ev.queue_depth for ev in self.steps]
        occ = [ev.occupancy for ev in self.steps if ev.kind == "decode"]
        tokens = sum(r.tokens_out for r in self.requests)
        return {
            "requests": len(self.requests),
            "steps": len(self.steps),
            "span_s": span,
            "throughput_tok_s": tokens / span if span > 0 else 0.0,
            "queue_depth_max": max(depths, default=0),
            "queue_depth_mean": float(np.mean(depths)) if depths else 0.0,
            "decode_occupancy_mean": (float(np.mean(occ)) if occ else 0.0),
            "per_tenant": {t: self._tenant_summary(
                [r for r in self.requests if r.tenant == t])
                for t in tenants},
            "faults": {
                "counters": self.fault_counters(),
                "flagged_steps": len(self.detection_steps()),
                "injections": [i.to_dict() for i in self.injections],
                "injections_detected": sum(
                    1 for i in self.injections if i.detected),
                "suspect_requests": sum(
                    1 for r in self.requests if r.suspect),
            },
            **({"monitor": self.monitor}
               if self.monitor is not None else {}),
            **({"thresholds": self.thresholds}
               if self.thresholds is not None else {}),
        }

    def to_dict(self) -> dict:
        return {
            "schema_version": TELEMETRY_SCHEMA_VERSION,
            "summary": self.summary(),
            "requests": [r.to_dict() for r in self.requests],
            "steps": [ev.to_dict() for ev in self.steps],
        }


__all__ = ["Telemetry", "RequestRecord", "StepEvent", "InjectionRecord",
           "percentiles_ms", "PCTS", "TELEMETRY_SCHEMA_VERSION"]
