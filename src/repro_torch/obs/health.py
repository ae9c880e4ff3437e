"""Quarantine-grade health state machine for monitored scopes.

One :class:`HealthTracker` per scope (a tenant, a campaign cell, an op
kind) walks ``healthy → degraded → quarantined`` on alert pressure and
back down one state at a time on sustained quiet — the hysteresis that
keeps a single noisy window from flapping a lane in and out of
quarantine.  Time is measured in **evaluation ticks** (one per monitor
evaluation, i.e. one per observed step), not wall seconds, so the
machine is deterministic under the serving engine's hybrid clock.

Escalation:

* ``healthy``: ``degrade_after`` consecutive alerting ticks → ``degraded``
  (a quarantine-severity alert jumps straight to ``quarantined``);
* ``degraded``: a quarantine-severity alert, or ``quarantine_after``
  consecutive alerting ticks → ``quarantined``.

Recovery steps DOWN one state per ``recover_after`` consecutive clean
ticks (``quarantined → degraded → healthy``), resetting the clean streak
at each step so every level earns its own quiet period.  While
quarantined, :meth:`HealthTracker.take_probe` admits one recovery probe
every ``probe_every`` ticks — the engine uses it to let a single request
through a quarantined lane so clean evidence can accumulate.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

#: state order; transitions move one index at a time on recovery
HEALTH_STATES = ("healthy", "degraded", "quarantined")


@dataclasses.dataclass(frozen=True)
class HealthPolicy:
    """Hysteresis knobs, all in evaluation ticks."""
    degrade_after: int = 1      # alerting ticks: healthy -> degraded
    quarantine_after: int = 3   # alerting ticks while degraded
    recover_after: int = 4      # clean ticks per one-state step-down
    probe_every: int = 4        # quarantined: one probe per N ticks

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Transition:
    """One applied state change, as the monitor reports it."""
    scope: str                  # e.g. "tenant:premium", "op:qgemm"
    old: str
    new: str
    t_s: float
    tick: int
    reason: str = ""            # the alert rule(s) that drove it

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class HealthTracker:
    """Per-scope state machine; :meth:`update` is one evaluation tick."""

    def __init__(self, scope: str, policy: Optional[HealthPolicy] = None):
        self.scope = scope
        self.policy = policy if policy is not None else HealthPolicy()
        self.state = "healthy"
        self.tick = 0
        self.alert_streak = 0
        self.clean_streak = 0
        self.transitions: List[Transition] = []
        self._last_probe = 0

    def _move(self, new: str, t_s: float, reason: str) -> Transition:
        tr = Transition(scope=self.scope, old=self.state, new=new,
                        t_s=t_s, tick=self.tick, reason=reason)
        self.state = new
        self.alert_streak = 0
        self.clean_streak = 0
        if new == "quarantined":
            self._last_probe = self.tick     # first probe earns its wait
        self.transitions.append(tr)
        return tr

    def update(self, alerting: bool, t_s: float, *,
               quarantine_grade: bool = False,
               reason: str = "") -> Optional[Transition]:
        """Advance one tick; returns the transition applied, if any."""
        p = self.policy
        self.tick += 1
        if alerting:
            self.alert_streak += 1
            self.clean_streak = 0
            if self.state == "healthy" \
                    and self.alert_streak >= p.degrade_after:
                target = "quarantined" if quarantine_grade else "degraded"
                return self._move(target, t_s, reason)
            if self.state == "degraded" and (
                    quarantine_grade
                    or self.alert_streak >= p.quarantine_after):
                return self._move("quarantined", t_s, reason)
            return None
        self.clean_streak += 1
        self.alert_streak = 0
        if self.state != "healthy" and self.clean_streak >= p.recover_after:
            down = HEALTH_STATES[HEALTH_STATES.index(self.state) - 1]
            return self._move(down, t_s, reason or "recovered")
        return None

    def take_probe(self) -> bool:
        """While quarantined: True once per ``probe_every`` ticks (the
        admission the engine lets through as a recovery probe)."""
        if self.state != "quarantined":
            return True
        if self.tick - self._last_probe >= self.policy.probe_every:
            self._last_probe = self.tick
            return True
        return False

    def to_dict(self) -> dict:
        return {"scope": self.scope, "state": self.state,
                "tick": self.tick, "alert_streak": self.alert_streak,
                "clean_streak": self.clean_streak,
                "transitions": [t.to_dict() for t in self.transitions]}


__all__ = ["HEALTH_STATES", "HealthPolicy", "HealthTracker", "Transition"]
