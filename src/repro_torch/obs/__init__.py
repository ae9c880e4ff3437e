"""``repro_torch.obs`` — unified observability for the fault-detection stack.

Host-side primitives shared by campaign, training, and serving:

* :class:`EventBus` + :class:`FaultEvent` (``events.py``) — typed fault
  events with JSONL export and schema validation;
* :class:`Tracer` (``trace.py``) — timed spans with Chrome/Perfetto
  trace export;
* :class:`MetricsRegistry` (``metrics.py``) — counters/gauges/histograms
  with Prometheus-text and JSON exporters;
* :class:`Monitor` (``monitor.py``) + :mod:`repro_torch.obs.health` — live
  windowed rate estimators, alert rules, and quarantine-grade health
  states over the bus.

:class:`Observability` bundles bus/tracer/registry; pass one instance
through ``run_campaign(obs=...)`` / ``ServingEngine.run(obs=...)`` and
call :meth:`Observability.write` to drop
``events.jsonl`` / ``trace.json`` / ``metrics.prom`` / ``metrics.json``
into a directory — or :meth:`Observability.open_incremental` first so a
long soak flushes crash-durably as it runs.  ``FaultReport`` stays the
on-device counter set — obs is where its counters land once a step has
copied them to the host (``metrics_to_ints``).

**Counter-mirror invariant** (what makes :func:`replay` exact): every
live event emission site pairs with specific registry increments, and
``replay`` re-applies exactly those increments from the event stream —
so a registry rebuilt from ``obs_events.jsonl`` alone matches the live
run's fault-pipeline counters sample-for-sample.
"""
from __future__ import annotations

import dataclasses
import json
import os
from typing import Dict, Iterable, Optional, Union

from repro_torch.obs.events import (EVENT_KINDS, EVENT_SCHEMA,
                                    EVENT_SCHEMA_VERSION, EventBus,
                                    FaultEvent, events_from_metrics,
                                    validate_event)
from repro_torch.obs.health import (HEALTH_STATES, HealthPolicy,
                                    HealthTracker, Transition)
from repro_torch.obs.metrics import (DEFAULT_BUCKETS, Counter, Gauge,
                                     Histogram, MetricsRegistry,
                                     default_registry)
from repro_torch.obs.monitor import (AlertFiring, AlertRule,
                                     EngineResponses, Monitor,
                                     default_rules)
from repro_torch.obs.trace import Span, Tracer


@dataclasses.dataclass
class Observability:
    """One run's event bus, tracer, and metrics registry."""
    bus: EventBus
    tracer: Tracer
    registry: MetricsRegistry
    _flush: Optional[dict] = dataclasses.field(
        default=None, repr=False, compare=False)

    @classmethod
    def create(cls) -> "Observability":
        return cls(bus=EventBus(), tracer=Tracer(),
                   registry=MetricsRegistry())

    # --------------------------- incremental flushing ------------------------

    def open_incremental(self, out_dir: str, prefix: str = "obs",
                         every: int = 100) -> Dict[str, str]:
        """Make this bundle crash-durable: append each event to
        ``<prefix>_events.jsonl`` as it is emitted (fsync'd), and rewrite
        the metrics/trace snapshots every ``every`` events.  A final
        :meth:`write` to the same directory is still a full, clean
        rewrite.  Returns the artifact paths."""
        os.makedirs(out_dir, exist_ok=True)
        join = lambda ext: os.path.join(out_dir, f"{prefix}_{ext}")  # noqa: E731
        paths = {"events": join("events.jsonl"),
                 "trace": join("trace.json"),
                 "prometheus": join("metrics.prom"),
                 "metrics_json": join("metrics.json")}
        f = open(paths["events"], "w")
        state = {"dir": out_dir, "prefix": prefix, "every": max(1, every),
                 "file": f, "since_snapshot": 0, "paths": paths}
        self._flush = state

        def _on_event(ev, _state=state, _self=self):
            fh = _state["file"]
            if fh is None or fh.closed:
                return
            fh.write(json.dumps(ev.to_dict(), sort_keys=True) + "\n")
            fh.flush()
            os.fsync(fh.fileno())
            _state["since_snapshot"] += 1
            if _state["since_snapshot"] >= _state["every"]:
                _self.maybe_flush(force=True)

        self.bus.subscribe(_on_event)
        # events emitted before opening must not be lost
        for ev in self.bus.events:
            f.write(json.dumps(ev.to_dict(), sort_keys=True) + "\n")
        f.flush()
        os.fsync(f.fileno())
        self.maybe_flush(force=True)
        return paths

    def maybe_flush(self, force: bool = False) -> bool:
        """Rewrite the metrics/trace snapshots if the incremental sink
        is open and due (or ``force``).  Returns True when written."""
        state = self._flush
        if state is None:
            return False
        if not force and state["since_snapshot"] < state["every"]:
            return False
        state["since_snapshot"] = 0
        paths = state["paths"]
        self.tracer.write(paths["trace"])
        self.registry.write_prometheus(paths["prometheus"])
        self.registry.write_json(paths["metrics_json"])
        return True

    def write(self, out_dir: str, prefix: str = "obs") -> Dict[str, str]:
        """Export everything; returns {artifact kind: path}.  Closes the
        incremental sink (if open on the same directory) first so the
        full rewrite wins."""
        state = self._flush
        if state is not None:
            if state["file"] is not None and not state["file"].closed:
                state["file"].close()
            self._flush = None
        os.makedirs(out_dir, exist_ok=True)
        join = lambda ext: os.path.join(out_dir, f"{prefix}_{ext}")  # noqa: E731
        return {
            "events": self.bus.to_jsonl(join("events.jsonl")),
            "trace": self.tracer.write(join("trace.json")),
            "prometheus": self.registry.write_prometheus(
                join("metrics.prom")),
            "metrics_json": self.registry.write_json(
                join("metrics.json")),
        }


def replay(events: Union[str, EventBus, Iterable[FaultEvent]],
           registry: Optional[MetricsRegistry] = None) -> MetricsRegistry:
    """Rebuild the fault-pipeline counters from an exported event stream.

    ``events`` may be a JSONL path, an :class:`EventBus`, or an iterable
    of :class:`FaultEvent` — how a soak's ``obs_events.jsonl`` turns back
    into Prometheus text.

    Mirrors the live emission sites increment-for-increment:

    * ``detection`` — one ``repro_detections_total{op,source[,cell]}``
      inc per event (``observe_metrics`` pairs each flagged-op event
      with exactly one);
    * ``info``/``channel=step`` — the per-step summary's ``by_op``
      carries (checks, errors) per op kind →
      ``repro_abft_{checks,errors}_total{op,source}``;
    * ``info``/``channel=paging`` — ``repro_paging_ops_total{action,lane}``;
    * ``injection`` — ``repro_injections_total{source}``;
    * ``cell`` — the per-cell outcome counters the campaign/soak
      publishers inc (detections from ``attrs.effective_detected`` when
      present else ``errors``; injections from ``checks``; escapes /
      false_positives from attrs when the publisher emitted them);
    * ``threshold`` — adaptive-threshold controller moves →
      ``repro_threshold_adjustments_total{op,tenant,direction}`` + the
      ``repro_threshold_rel_bound`` gauge set to the new bound
      (``detector_value``);
    * ``alert`` (state=firing) — ``repro_alerts_total{rule,scope,severity}``;
    * ``health`` — monitor transitions →
      ``repro_health_transitions_total{scope,to}`` + the
      ``repro_health_state`` gauge; engine response actions →
      ``repro_health_actions_total{action,scope}``.

    ``false_positive`` cell-roll-up events carry no paired live inc (the
    ``cell`` event already covers the counter) and are replayed as
    events only.
    """
    if isinstance(events, str):
        events = EventBus.from_jsonl(events)
    registry = registry if registry is not None else MetricsRegistry()
    det = registry.counter(
        "repro_detections_total",
        "detected faults by op kind, source, and cell")
    fp = registry.counter(
        "repro_false_positives_total", "clean-run flags per cell")
    inj = registry.counter(
        "repro_injections_total", "injected faults by source and cell")
    esc = registry.counter(
        "repro_escapes_total", "undetected corruptions (SDC) per cell")
    errs = registry.counter(
        "repro_abft_errors_total", "residual ABFT errors by op kind")
    checks = registry.counter(
        "repro_abft_checks_total", "ABFT checks by op kind")
    for ev in events:
        if ev.kind == "detection":
            labels = {"op": ev.op, "source": ev.source}
            if ev.cell_id:
                labels["cell"] = ev.cell_id
            det.inc(1, **labels)
        elif ev.kind == "injection":
            inj.inc(1, source=ev.source)
        elif ev.kind == "cell":
            cell = ev.cell_id or ""
            det.inc(int(ev.attrs.get("effective_detected", ev.errors)),
                    cell=cell)
            inj.inc(int(ev.checks), cell=cell)
            if "escapes" in ev.attrs:
                esc.inc(int(ev.attrs["escapes"]), cell=cell)
            if "false_positives" in ev.attrs:
                fp.inc(int(ev.attrs["false_positives"]), cell=cell)
        elif ev.kind == "info":
            channel = ev.attrs.get("channel")
            if channel == "step":
                for op, ce in (ev.attrs.get("by_op") or {}).items():
                    checks.inc(int(ce[0]), op=op, source=ev.source)
                    errs.inc(int(ce[1]), op=op, source=ev.source)
            elif channel == "paging":
                registry.counter(
                    "repro_paging_ops_total",
                    "paged-KV lifecycle operations by action and lane"
                ).inc(1, action=str(ev.attrs.get("action", "")),
                      lane=str(ev.attrs.get("lane", "")))
        elif ev.kind == "threshold":
            op = ev.op
            tenant = str(ev.attrs.get("tenant", "*"))
            registry.counter(
                "repro_threshold_adjustments_total",
                "threshold-controller moves by op, tenant, and direction"
            ).inc(1, op=op, tenant=tenant,
                  direction=str(ev.attrs.get("direction", "")))
            if ev.detector_value is not None:
                registry.gauge(
                    "repro_threshold_rel_bound",
                    "current adaptive rel_bound per op and tenant").set(
                        float(ev.detector_value), op=op, tenant=tenant)
        elif ev.kind == "alert":
            if ev.attrs.get("state") == "firing":
                registry.counter(
                    "repro_alerts_total",
                    "alert-rule firings by rule and scope").inc(
                        1, rule=str(ev.attrs.get("rule", "")),
                        scope=str(ev.attrs.get("scope", "")),
                        severity=str(ev.attrs.get("severity", "")))
        elif ev.kind == "health":
            if "action" in ev.attrs:
                registry.counter(
                    "repro_health_actions_total",
                    "engine responses to health transitions").inc(
                        1, action=str(ev.attrs["action"]),
                        scope=str(ev.attrs.get("scope", "")))
            else:
                scope = str(ev.attrs.get("scope", ""))
                to = str(ev.attrs.get("to", ""))
                registry.counter(
                    "repro_health_transitions_total",
                    "health state transitions by scope").inc(
                        1, scope=scope, to=to)
                if to in HEALTH_STATES:
                    registry.gauge(
                        "repro_health_state",
                        "current health (0 healthy / 1 degraded / "
                        "2 quarantined)").set(
                            HEALTH_STATES.index(to), scope=scope)
    return registry


__all__ = ["Observability", "replay", "EventBus", "FaultEvent",
           "events_from_metrics", "validate_event", "EVENT_SCHEMA",
           "EVENT_SCHEMA_VERSION", "EVENT_KINDS", "Tracer", "Span",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "default_registry", "DEFAULT_BUCKETS",
           "Monitor", "AlertRule", "AlertFiring", "EngineResponses",
           "default_rules", "HealthPolicy", "HealthTracker", "Transition",
           "HEALTH_STATES"]
