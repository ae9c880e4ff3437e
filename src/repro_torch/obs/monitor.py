"""Live detection-health monitor over the obs event bus.

:class:`Monitor` subscribes to an :class:`~repro_torch.obs.EventBus` and keeps
sliding-window estimators per ``(op, tenant, cell)`` scope — windowed
detection counts and rates, false-positive rate vs. check count with
Wilson intervals, an escape proxy (injections seen minus flags seen),
and step-latency percentiles.  A declarative :class:`AlertRule` set is
evaluated on every observed step; firings drive a per-scope
``healthy → degraded → quarantined`` state machine
(:mod:`repro_torch.obs.health`) with hysteresis and recovery probes.

Every consumer that already publishes into an ``Observability`` bundle
feeds the monitor for free: the serving engine's per-step summaries
(kind ``info`` / ``channel=step``, carrying per-op check/error counts,
resident tenants, and the step's wall duration), the campaign
executor's / serving soak's ``cell`` summaries, and injection events.
Alert firings and health transitions are emitted back onto the same bus
as typed events (schema v2 kinds ``alert`` / ``health``) plus registry
counters and tracer instants, so the whole control loop replays from
``obs_events.jsonl`` alone.

Windows are **tick-based by default** (last N observed steps per scope)
so alerting is deterministic under the engine's hybrid clock; time-based
windows (``window_s``) remain available for wall-rate rules like
``detections_per_s``.
"""
from __future__ import annotations

import dataclasses
import fnmatch
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.obs.health import (HEALTH_STATES, HealthPolicy,
                                    HealthTracker, Transition)

_SEVERITIES = ("warn", "degrade", "quarantine")
_SEV_ORDER = {s: i for i, s in enumerate(_SEVERITIES)}
_CMPS = {">": lambda a, b: a > b, ">=": lambda a, b: a >= b,
         "<": lambda a, b: a < b, "<=": lambda a, b: a <= b}

#: metrics an AlertRule may watch
RULE_METRICS = ("detections", "detections_per_s", "checks", "flag_rate",
                "flag_rate_low", "flag_rate_high", "fp_rate",
                "fp_rate_low", "escape_proxy", "latency_p99_ms")


def wilson_interval(k: int, n: int, z: float = 1.96
                    ) -> Tuple[float, float]:
    """Wilson score interval for k successes in n trials (duplicated
    from ``repro_torch.campaign.metrics`` to keep obs import-free of the
    campaign layer).  As the JAX monitor's, it raises for ``k > n``
    (ROADMAP §C9)."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / n
                                   + z * z / (4 * n * n))
    return (max(0.0, center - half), min(1.0, center + half))


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One declarative alert condition.

    ``metric`` is computed per matching scope over the last
    ``window_ticks`` samples (or the last ``window_s`` seconds when
    ``window_ticks`` is 0).  With ``long_window_ticks``/``long_window_s``
    set, the rule is SLO burn-rate style: it fires only when BOTH the
    short and the long window exceed their thresholds (``long_threshold``
    defaults to ``threshold``), so a brief spike on an otherwise-quiet
    scope doesn't page.  ``severity`` feeds the health machine: ``warn``
    only records, ``degrade`` counts as alert pressure, ``quarantine``
    escalates the scope straight to quarantined."""
    name: str
    metric: str
    threshold: float
    cmp: str = ">="
    window_ticks: int = 8
    window_s: float = 0.0
    long_window_ticks: int = 0
    long_window_s: float = 0.0
    long_threshold: Optional[float] = None
    min_checks: int = 0          # rate metrics: skip below this many checks
    min_samples: int = 1
    op: str = "*"                # fnmatch over the scope's op kind
    tenant: str = "*"
    cell: str = "*"
    severity: str = "degrade"

    def __post_init__(self):
        if self.metric not in RULE_METRICS:
            raise ValueError(f"rule {self.name!r}: unknown metric "
                             f"{self.metric!r}; have {RULE_METRICS}")
        if self.cmp not in _CMPS:
            raise ValueError(f"rule {self.name!r}: unknown cmp "
                             f"{self.cmp!r}; have {tuple(_CMPS)}")
        if self.severity not in _SEVERITIES:
            raise ValueError(f"rule {self.name!r}: unknown severity "
                             f"{self.severity!r}; have {_SEVERITIES}")
        if not (self.window_ticks or self.window_s):
            raise ValueError(f"rule {self.name!r}: needs window_ticks "
                             f"or window_s")

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_rules() -> Tuple[AlertRule, ...]:
    """The stock rule set the CLIs enable with ``--monitor``."""
    return (
        # a burst of detections within a handful of steps: degrade
        AlertRule("detection-burst", metric="detections", threshold=2,
                  cmp=">=", window_ticks=8, severity="degrade"),
        # sustained detections every step (persistent fault): quarantine
        AlertRule("detection-storm", metric="detections", threshold=6,
                  cmp=">=", window_ticks=12, severity="quarantine"),
        # burn-rate FP budget: Wilson lower bound above budget in BOTH
        # the short and the long window
        AlertRule("fp-budget-burn", metric="fp_rate_low", threshold=0.02,
                  cmp=">", window_ticks=32, long_window_ticks=128,
                  min_checks=40, severity="degrade"),
        # injections observed with no matching flags: detector may be off
        AlertRule("escape-proxy", metric="escape_proxy", threshold=1,
                  cmp=">=", window_ticks=16, severity="warn"),
    )


@dataclasses.dataclass(frozen=True)
class EngineResponses:
    """Which real responses the serving engine applies on transitions."""
    quarantine: bool = True      # gate the tenant's admissions
    escalate: bool = True        # upgrade the lane's ProtectionPlan
    scrub: bool = True           # scrub + repair the lane's paged KV

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class AlertFiring:
    """One rising-edge alert occurrence (until resolved)."""
    rule: str
    severity: str
    metric: str
    scope: str                   # health-scope label, e.g. "tenant:x"
    op: str
    tenant: str
    cell: str
    value: float
    threshold: float
    t_s: float
    tick: int
    resolved_t_s: Optional[float] = None

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class _Window:
    """Per-scope sample store: (tick, t, errors, checks) step samples
    plus (tick, t, ms) latency samples, bounded deques.  Samples carry
    the evaluation tick they were observed on so tick-windows age them
    out during idle ticks (otherwise a quarantined, traffic-gated scope
    would keep its last flagged samples in-window forever and never
    recover)."""
    __slots__ = ("samples", "lat")

    def __init__(self, maxlen: int = 2048):
        self.samples: deque = deque(maxlen=maxlen)
        self.lat: deque = deque(maxlen=maxlen)


def _percentile(values: List[float], q: float) -> float:
    if not values:
        return 0.0
    vs = sorted(values)
    idx = min(len(vs) - 1, max(0, int(math.ceil(q * len(vs))) - 1))
    return vs[idx]


def health_scope(op: str, tenant: str, cell: str) -> str:
    """The health-machine key an alert on (op, tenant, cell) rolls up
    to: tenants first (they gate admissions), then cells, then ops."""
    if tenant:
        return f"tenant:{tenant}"
    if cell:
        return f"cell:{cell}"
    return f"op:{op}"


class Monitor:
    """Streaming alert evaluator + health machine over the obs bus."""

    def __init__(self, rules: Optional[Sequence[AlertRule]] = None,
                 health: Optional[HealthPolicy] = None,
                 responses: Optional[EngineResponses] = None):
        self.rules: Tuple[AlertRule, ...] = tuple(
            rules if rules is not None else default_rules())
        self.health_policy = health if health is not None else \
            HealthPolicy()
        self.responses = responses if responses is not None else \
            EngineResponses()
        self._windows: Dict[Tuple[str, str, str], _Window] = {}
        self._match_cache: Dict[tuple, bool] = {}
        self._inj: deque = deque(maxlen=2048)   # (tick, t_s) injections
        self._active: Dict[Tuple[str, Tuple[str, str, str]],
                           AlertFiring] = {}
        self.alerts: List[AlertFiring] = []
        self.trackers: Dict[str, HealthTracker] = {}
        self._pending: List[Transition] = []
        self._obs = None
        self._tick = 0
        self._now = 0.0

    # ------------------------------ wiring -----------------------------------

    def bind(self, obs) -> "Monitor":
        """Subscribe to ``obs.bus`` (idempotent per bundle) and emit
        alert/health events + counters into the same bundle."""
        if obs is not None and obs is not self._obs:
            self._obs = obs
            obs.bus.subscribe(self.on_event)
        return self

    def on_event(self, ev) -> None:
        """Bus subscriber: folds every published event into the windows.
        The monitor's own ``alert``/``health`` events are ignored, so
        subscribing to the bus it emits into cannot recurse."""
        if ev.kind in ("alert", "health"):
            return
        if ev.kind == "injection":
            self._inj.append((self._tick + 1, ev.t_s))
            return
        if ev.kind == "cell":
            eff = int(ev.attrs.get("effective_detected", ev.errors))
            self.record_step(
                ev.t_s, {ev.op: (int(ev.checks), eff)},
                cell=ev.cell_id or "")
            return
        if ev.kind == "info" and ev.attrs.get("channel") == "step":
            by_op = {op: (int(ce[0]), int(ce[1]))
                     for op, ce in (ev.attrs.get("by_op") or {}).items()}
            self.record_step(
                ev.t_s, by_op,
                tenants=tuple(ev.attrs.get("tenants") or ()),
                duration_ms=ev.attrs.get("duration_ms"),
                kind=str(ev.attrs.get("kind", "")))
        # detection / false_positive events are per-op echoes of the
        # step summary — counting them too would double the windows

    # ------------------------------ ingestion --------------------------------

    def _window(self, op: str, tenant: str, cell: str) -> _Window:
        key = (op, tenant, cell)
        w = self._windows.get(key)
        if w is None:
            w = self._windows[key] = _Window()
        return w

    def record_step(self, t_s: float,
                    by_op: Dict[str, Tuple[int, int]], *,
                    tenants: Sequence[str] = (), cell: str = "",
                    duration_ms: Optional[float] = None,
                    kind: str = "") -> List[Transition]:
        """Fold one observed step into the windows and run an
        evaluation tick.  ``by_op`` maps op kind -> (checks, errors);
        counts are attributed to every resident tenant (a lane-step's
        flag blames everyone resident, same as request attribution).
        Returns any newly applied health transitions."""
        scopes = list(tenants) or [""]
        tick = self._tick + 1                 # the tick evaluate() runs
        for op, (checks, errors) in by_op.items():
            for tn in scopes:
                self._window(op, tn, cell).samples.append(
                    (tick, t_s, int(errors), int(checks)))
        if duration_ms is not None:
            for tn in scopes:
                self._window(f"step/{kind or 'step'}", tn, cell).lat \
                    .append((tick, t_s, float(duration_ms)))
        return self.evaluate(t_s)

    def idle_tick(self, t_s: float) -> List[Transition]:
        """A no-step evaluation tick (the engine calls this while all
        admissions are gated, so probes unlock and recovery can run)."""
        return self.evaluate(t_s)

    # ------------------------------ estimators -------------------------------

    @staticmethod
    def _tail(samples: deque, key: int, cutoff: float,
              strict: bool) -> List[tuple]:
        """The suffix of a tick/time-ordered deque past ``cutoff`` —
        scanned from the right with early exit, so a full 2048-sample
        deque costs only the window, not the history."""
        sel: List[tuple] = []
        for s in reversed(samples):
            if (s[key] <= cutoff) if strict else (s[key] < cutoff):
                break
            sel.append(s)
        sel.reverse()
        return sel

    def _agg(self, win: _Window, ticks: int, seconds: float,
             now: float) -> Tuple[int, int, int, int, float]:
        """One fused early-exit pass over the window's tail:
        (n, errors, checks, flagged, t0).  This runs per rule per tick
        on the hot path — no intermediate lists."""
        n = errors = checks = flagged = 0
        t0 = now
        if ticks > 0:
            cutoff = self._tick - ticks
            for s in reversed(win.samples):
                if s[0] <= cutoff:
                    break
                n += 1
                errors += s[2]
                checks += s[3]
                flagged += s[2] > 0
                t0 = s[1]
        else:
            cutoff_t = now - seconds
            for s in reversed(win.samples):
                if s[1] < cutoff_t:
                    break
                n += 1
                errors += s[2]
                checks += s[3]
                flagged += s[2] > 0
                t0 = s[1]
        return n, errors, checks, flagged, t0

    def _inj_in_window(self, ticks: int, seconds: float,
                       now: float) -> int:
        if ticks > 0:
            return len(self._tail(self._inj, 0, self._tick - ticks,
                                  True))
        return len(self._tail(self._inj, 1, now - seconds, False))

    def _metric_value(self, win: _Window, rule: AlertRule, now: float,
                      *, long: bool = False) -> Optional[float]:
        ticks = rule.long_window_ticks if long else rule.window_ticks
        seconds = rule.long_window_s if long else rule.window_s
        if long and not (ticks or seconds):
            return None
        m = rule.metric
        # empty windows can never clear min_samples — skip the scan
        if not (win.lat if m == "latency_p99_ms" else win.samples):
            return None
        if m == "latency_p99_ms":
            if ticks > 0:
                lat = [s[2] for s in self._tail(
                    win.lat, 0, self._tick - ticks, True)]
            else:
                lat = [s[2] for s in self._tail(
                    win.lat, 1, now - seconds, False)]
            if len(lat) < max(1, rule.min_samples):
                return None
            return _percentile(lat, 0.99)
        n, errors, checks, flagged, t0 = self._agg(win, ticks, seconds,
                                                   now)
        if n < max(1, rule.min_samples):
            return None
        if m == "detections":
            return float(errors)
        if m == "checks":
            return float(checks)
        if m == "detections_per_s":
            return errors / max(now - t0, 1e-9)
        if m == "escape_proxy":
            inj = self._inj_in_window(ticks, seconds, now)
            return float(max(0, inj - flagged))
        # rate metrics below need checks
        if checks < max(1, rule.min_checks):
            return None
        if m.startswith("fp_rate"):
            # FP proxy: flags with no known injection in the window are
            # presumed false (exactly right on clean runs)
            if self._inj_in_window(ticks, seconds, now):
                return 0.0
        lo, hi = wilson_interval(errors, checks)
        if m in ("flag_rate", "fp_rate"):
            return errors / checks
        if m in ("flag_rate_low", "fp_rate_low"):
            return lo
        return hi                                     # flag_rate_high

    def estimate(self, *, op: str = "*", tenant: str = "*",
                 cell: str = "*", window_ticks: int = 32) -> dict:
        """Windowed FP/detection estimate over matching scopes — the
        sensor ROADMAP item 2's threshold controller reads."""
        errors = checks = n = 0
        for (o, tn, cl), win in self._windows.items():
            if not (fnmatch.fnmatch(o, op) and fnmatch.fnmatch(tn, tenant)
                    and fnmatch.fnmatch(cl, cell)):
                continue
            wn, we, wc, _, _ = self._agg(win, window_ticks, 0.0,
                                         self._now)
            errors += we
            checks += wc
            n += wn
        lo, hi = wilson_interval(errors, checks) if checks else (0.0, 1.0)
        return {"samples": n, "errors": errors, "checks": checks,
                "flag_rate": errors / checks if checks else 0.0,
                "flag_rate_low": lo, "flag_rate_high": hi}

    # ------------------------------ evaluation -------------------------------

    def _rule_matches(self, rule: AlertRule,
                      key: Tuple[str, str, str]) -> bool:
        # memoized: the (rule, scope) product is re-walked every tick
        # and fnmatch is the hot path otherwise
        ck = (rule.name, key)
        hit = self._match_cache.get(ck)
        if hit is None:
            op, tenant, cell = key
            hit = ((rule.op == "*" or fnmatch.fnmatch(op, rule.op))
                   and (rule.tenant == "*"
                        or fnmatch.fnmatch(tenant, rule.tenant))
                   and (rule.cell == "*"
                        or fnmatch.fnmatch(cell, rule.cell)))
            self._match_cache[ck] = hit
        return hit

    def evaluate(self, t_s: float) -> List[Transition]:
        """One evaluation tick: re-check every rule against every scope,
        emit rising/falling alert edges, advance every health tracker.
        Returns the newly applied transitions (also queued for
        :meth:`poll_transitions`)."""
        self._now = max(self._now, t_s)
        self._tick += 1
        for rule in self.rules:
            for key, win in list(self._windows.items()):
                if not self._rule_matches(rule, key):
                    continue
                value = self._metric_value(win, rule, self._now)
                firing = value is not None and \
                    _CMPS[rule.cmp](value, rule.threshold)
                if firing and (rule.long_window_ticks
                               or rule.long_window_s):
                    lv = self._metric_value(win, rule, self._now,
                                            long=True)
                    lt = rule.long_threshold if rule.long_threshold \
                        is not None else rule.threshold
                    firing = lv is not None and _CMPS[rule.cmp](lv, lt)
                akey = (rule.name, key)
                if firing and akey not in self._active:
                    op, tenant, cell = key
                    f = AlertFiring(
                        rule=rule.name, severity=rule.severity,
                        metric=rule.metric,
                        scope=health_scope(op, tenant, cell),
                        op=op, tenant=tenant, cell=cell,
                        value=float(value), threshold=rule.threshold,
                        t_s=self._now, tick=self._tick)
                    self._active[akey] = f
                    self.alerts.append(f)
                    self._emit_alert(f, "firing")
                elif firing:
                    self._active[akey].value = float(value)
                elif akey in self._active:
                    f = self._active.pop(akey)
                    f.resolved_t_s = self._now
                    self._emit_alert(f, "resolved")

        # one health tick per evaluation, every known scope
        pressure: Dict[str, str] = {}       # scope -> max severity
        reasons: Dict[str, List[str]] = {}
        for f in self._active.values():
            if _SEV_ORDER[f.severity] < _SEV_ORDER["degrade"]:
                continue                     # warn never degrades health
            cur = pressure.get(f.scope)
            if cur is None or _SEV_ORDER[f.severity] > _SEV_ORDER[cur]:
                pressure[f.scope] = f.severity
            reasons.setdefault(f.scope, []).append(f.rule)
        applied: List[Transition] = []
        for scope in set(self.trackers) | set(pressure):
            tr = self.trackers.get(scope)
            if tr is None:
                tr = self.trackers[scope] = HealthTracker(
                    scope, self.health_policy)
            t = tr.update(
                scope in pressure, self._now,
                quarantine_grade=pressure.get(scope) == "quarantine",
                reason=",".join(sorted(set(reasons.get(scope, ())))))
            if t is not None:
                applied.append(t)
                self._emit_health(t)
        self._pending.extend(applied)
        return applied

    # ------------------------------ queries ----------------------------------

    def poll_transitions(self) -> List[Transition]:
        """Drain transitions applied since the last poll (the engine's
        response hook)."""
        out, self._pending = self._pending, []
        return out

    def state(self, scope: str) -> str:
        tr = self.trackers.get(scope)
        return tr.state if tr is not None else "healthy"

    def tenant_state(self, tenant: str) -> str:
        return self.state(f"tenant:{tenant}")

    def admission_allowed(self, tenant: str) -> bool:
        """False while the tenant's scope is quarantined, except for one
        recovery probe every ``probe_every`` ticks."""
        tr = self.trackers.get(f"tenant:{tenant}")
        if tr is None:
            return True
        return tr.take_probe()

    def active_alerts(self) -> List[AlertFiring]:
        return list(self._active.values())

    def summary(self) -> dict:
        transitions = sorted(
            (t for tr in self.trackers.values() for t in tr.transitions),
            key=lambda t: (t.t_s, t.tick))
        return {
            "ticks": self._tick,
            "rules": [r.name for r in self.rules],
            "responses": self.responses.to_dict(),
            "alerts_fired": len(self.alerts),
            "alerts": [f.to_dict() for f in self.alerts],
            "active_alerts": [f.to_dict()
                              for f in self._active.values()],
            "health": {s: tr.state
                       for s, tr in sorted(self.trackers.items())},
            "transitions": [t.to_dict() for t in transitions],
        }

    # ------------------------------ emission ---------------------------------

    def _emit_alert(self, f: AlertFiring, state: str) -> None:
        obs = self._obs
        if obs is None:
            return
        from repro_torch.obs.events import FaultEvent
        if state == "firing":
            obs.registry.counter(
                "repro_alerts_total",
                "alert-rule firings by rule and scope").inc(
                    1, rule=f.rule, scope=f.scope, severity=f.severity)
        obs.tracer.add_span(f"alert:{f.rule}", cat="monitor",
                            start_s=f.t_s, dur_s=0.0, scope=f.scope,
                            state=state)
        obs.bus.emit(FaultEvent(
            op=f.op, step=f.tick, source="obs.monitor", kind="alert",
            t_s=self._now, cell_id=f.cell or None,
            detector_value=f.value, bound=f.threshold,
            attrs={"rule": f.rule, "severity": f.severity,
                   "metric": f.metric, "scope": f.scope,
                   "tenant": f.tenant, "state": state}))

    def _emit_health(self, t: Transition) -> None:
        obs = self._obs
        if obs is None:
            return
        from repro_torch.obs.events import FaultEvent
        obs.registry.counter(
            "repro_health_transitions_total",
            "health state transitions by scope").inc(
                1, scope=t.scope, to=t.new)
        obs.registry.gauge(
            "repro_health_state",
            "current health (0 healthy / 1 degraded / 2 quarantined)"
        ).set(HEALTH_STATES.index(t.new), scope=t.scope)
        obs.tracer.add_span(f"health:{t.scope}", cat="monitor",
                            start_s=t.t_s, dur_s=0.0,
                            to=t.new)
        obs.bus.emit(FaultEvent(
            op="health", step=t.tick, source="obs.monitor",
            kind="health", t_s=t.t_s,
            attrs={"scope": t.scope, "from": t.old, "to": t.new,
                   "reason": t.reason, "tick": t.tick}))


__all__ = ["AlertRule", "AlertFiring", "EngineResponses", "Monitor",
           "RULE_METRICS", "default_rules", "health_scope",
           "wilson_interval"]
