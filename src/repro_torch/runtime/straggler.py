"""Straggler detection from step-time telemetry (the JAX package's
``runtime/straggler.py``, unchanged: pure host-side Python over step
times the loop already has, no device cost).

Flags a step slower than ``threshold`` x the rolling median; after
``patience`` consecutive flags the policy callback fires.  With per-host
step times it also names the hosts ``threshold`` x slower than the fleet
median.
"""
from __future__ import annotations

import collections
import time
from typing import Callable, Deque, Dict, List, Optional


class StragglerMonitor:
    def __init__(self, *, window: int = 50, threshold: float = 2.0,
                 patience: int = 3,
                 on_straggler: Optional[Callable[[dict], None]] = None):
        self.window = window
        self.threshold = threshold
        self.patience = patience
        self.on_straggler = on_straggler
        self._times: Deque[float] = collections.deque(maxlen=window)
        self._consecutive = 0
        self._last_start: Optional[float] = None
        self.events: List[dict] = []

    def step_start(self):
        self._last_start = time.monotonic()

    def step_end(self, step: int, host_times: Optional[Dict[int, float]]
                 = None) -> Optional[dict]:
        """Record a step; returns an event dict if this step straggled."""
        assert self._last_start is not None, "step_start not called"
        dt = time.monotonic() - self._last_start
        self._last_start = None
        return self.observe(step, dt, host_times)

    def observe(self, step: int, dt: float,
                host_times: Optional[Dict[int, float]] = None
                ) -> Optional[dict]:
        med = self.median()
        self._times.append(dt)
        event = None
        if med is not None and dt > self.threshold * med:
            self._consecutive += 1
            event = {"step": step, "dt": dt, "median": med,
                     "ratio": dt / med,
                     "consecutive": self._consecutive}
            if host_times:
                fleet_med = sorted(host_times.values())[len(host_times) // 2]
                event["slow_hosts"] = [
                    h for h, t in host_times.items()
                    if t > self.threshold * fleet_med]
            self.events.append(event)
            if (self._consecutive >= self.patience
                    and self.on_straggler is not None):
                self.on_straggler(event)
                self._consecutive = 0
        else:
            self._consecutive = 0
        return event

    def median(self) -> Optional[float]:
        if len(self._times) < max(5, self.window // 10):
            return None
        s = sorted(self._times)
        return s[len(s) // 2]

    def summary(self) -> dict:
        return {"steps": len(self._times), "median": self.median(),
                "straggler_events": len(self.events)}
