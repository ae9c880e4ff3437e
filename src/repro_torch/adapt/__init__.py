"""``repro_torch.adapt`` — V-ABFT adaptive thresholds with an online
FP-budget controller (the JAX package's ``adapt``, pure Python).

The paper's EmbeddingBag detector (Eq. 5) compares the checksum residual
against ``rel_bound * max(mag, 1)`` where ``rel_bound`` has so far been a
static constant swept offline via ``--grid thresholds``.  Per V-ABFT
(arxiv 2602.08043) a threshold derived from the *observed* residual
variance dominates any fixed constant in mixed precision, and the right
operating point drifts with workload mix — so this module closes the
loop:

* :class:`VarianceModel` — per-op online EWMA estimators of the clean
  checksum-residual ratio (and, optionally, of the EB activation
  magnitudes it is normalized by); maps a target FP quantile to a
  ``rel_bound`` via the normal quantile of the tracked distribution.
  This is the *open-loop* prior: what the bound should be if the
  residual stream is the whole story.
* :class:`ThresholdController` — the *closed loop*: one controller per
  (op, tenant) reads the :class:`repro_torch.obs.Monitor`'s Wilson-interval
  flag-rate estimate each evaluation tick and nudges ``rel_bound`` with
  bounded multiplicative steps (hysteresis deadband, hard floor/ceiling,
  cooldown between moves) to hold a configured FP budget while
  maximizing detection (the bound only rises when the Wilson *lower*
  bound exceeds the budget — i.e. when the FP overrun is statistically
  certain — and tightens when the Wilson *upper* bound sits safely
  under it).
* :class:`AdaptiveThresholds` — the per-run manager: owns controllers,
  ticks them from a Monitor, and emits every adjustment as a typed
  schema-v3 ``threshold`` event paired with registry increments (the
  live↔replay counter-mirror invariant extends to these events).
* :func:`calibrate_from_sweep` — seeds a controller's initial bound from
  a committed ``--grid thresholds`` sweep artifact: the sweep is the
  calibration tool, the controller keeps it on-budget online.

Direction convention: *raising* the FP budget buys a *tighter* (lower)
converged ``rel_bound`` — more FP headroom is spent on detection.  A
zero-FP stream therefore converges at the floor and stops moving.
"""
from __future__ import annotations

import dataclasses
import math
from statistics import NormalDist
from typing import Dict, Iterable, List, Optional, Tuple

#: registry names for the counter-mirror invariant (replay re-applies
#: these from ``threshold`` events)
ADJUSTMENTS_COUNTER = "repro_threshold_adjustments_total"
REL_BOUND_GAUGE = "repro_threshold_rel_bound"

_NORMAL = NormalDist()


@dataclasses.dataclass(frozen=True)
class ControllerConfig:
    """Tuning for one FP-budget control loop.

    ``fp_budget`` is the tolerated clean-flag (false-positive) rate.
    Moves are multiplicative by ``step`` and clamped to
    ``[floor, ceiling]``; ``hysteresis`` widens the deadband (the bound
    only tightens when the Wilson upper bound sits under
    ``fp_budget * hysteresis``), ``min_checks`` makes the controller
    abstain on thin evidence, ``cooldown_ticks`` spaces moves so each
    one's effect is observed before the next, and the loop counts as
    converged after ``settle_ticks`` evidence-bearing ticks without a
    move."""
    fp_budget: float = 0.01
    floor: float = 1e-7
    ceiling: float = 1e-2
    step: float = 1.5
    hysteresis: float = 0.5
    min_checks: int = 64
    cooldown_ticks: int = 2
    settle_ticks: int = 8
    window_ticks: int = 32

    def __post_init__(self):
        if not (0.0 < self.fp_budget < 1.0):
            raise ValueError("fp_budget must be in (0, 1)")
        if not (0.0 < self.floor <= self.ceiling):
            raise ValueError("need 0 < floor <= ceiling")
        if self.step <= 1.0:
            raise ValueError("step must be > 1 (multiplicative)")
        if not (0.0 < self.hysteresis <= 1.0):
            raise ValueError("hysteresis must be in (0, 1]")


class VarianceModel:
    """Online EWMA mean/variance of the clean residual ratio (and,
    optionally, of the raw EB activation magnitudes).

    ``observe`` folds clean-pass residual samples in; ``rel_bound(q)``
    returns the threshold at which a fraction ``q`` of the tracked
    (assumed-normal) residual distribution would flag — the open-loop
    V-ABFT bound for a target FP quantile ``q``.  When magnitudes are
    supplied alongside raw residuals, the ratio ``r / max(mag, 1)`` is
    what gets tracked, matching Eq. (5)'s comparison exactly."""

    def __init__(self, decay: float = 0.98):
        if not (0.0 < decay < 1.0):
            raise ValueError("decay must be in (0, 1)")
        self.decay = decay
        self.count = 0
        self._mean = 0.0
        self._var = 0.0
        self._mag_mean = 0.0

    def observe(self, residuals: Iterable[float],
                magnitudes: Optional[Iterable[float]] = None) -> None:
        if magnitudes is not None:
            pairs = [(float(r), float(m))
                     for r, m in zip(residuals, magnitudes)]
            values = [r / max(m, 1.0) for r, m in pairs]
            mags = [m for _, m in pairs]
        else:
            values = [float(r) for r in residuals]
            mags = []
        d = self.decay
        for v in values:
            if self.count == 0:
                self._mean, self._var = v, 0.0
            else:
                delta = v - self._mean
                self._mean += (1.0 - d) * delta
                # EWMA variance (West 1979 exponential form)
                self._var = d * (self._var + (1.0 - d) * delta * delta)
            self.count += 1
        for m in mags:
            self._mag_mean = (d * self._mag_mean + (1.0 - d) * m
                              if self._mag_mean else m)

    @property
    def mean(self) -> float:
        return self._mean

    @property
    def std(self) -> float:
        return math.sqrt(max(self._var, 0.0))

    @property
    def mag_mean(self) -> float:
        return self._mag_mean

    def rel_bound(self, fp_quantile: float, *, floor: float = 0.0,
                  ceiling: float = math.inf) -> float:
        """The bound at which the tracked ratio distribution flags with
        probability ``fp_quantile`` (normal-quantile approximation),
        clamped to ``[floor, ceiling]``."""
        if not (0.0 < fp_quantile < 1.0):
            raise ValueError("fp_quantile must be in (0, 1)")
        if self.count == 0:
            raise ValueError("no observations folded in yet")
        z = _NORMAL.inv_cdf(1.0 - fp_quantile)
        return min(max(self._mean + z * self.std, floor), ceiling)


class ThresholdController:
    """One (op, tenant)'s FP-budget control loop over ``rel_bound``.

    Feed it the Monitor's :meth:`~repro_torch.obs.Monitor.estimate` dict once
    per evaluation tick; it returns the new bound when it moved, else
    ``None``.  Control law (all comparisons against Wilson interval
    endpoints, so moves only happen on statistically-backed evidence):

    * ``flag_rate_low > fp_budget`` — the FP overrun is certain: loosen
      (raise) the bound by ``×step``;
    * ``flag_rate_high < fp_budget * hysteresis`` — comfortably under
      budget: tighten (lower) by ``÷step`` to buy detection;
    * otherwise hold (deadband).

    Two refinements make the loop stable on real residual streams:

    * **fresh evidence only** — flags recorded before the last move were
      measured against a *different* bound; :meth:`evidence_window`
      clamps the estimator window to ticks-since-last-move so a move's
      effect is judged on its own evidence (otherwise stale flags keep
      driving same-direction moves for a full window after the bound is
      already right — runaway overshoot);
    * **cliff memory** — quantized residual distributions are steplike:
      fp(bound) can jump from ~0 to far over budget across a single
      multiplicative step, so no bound lands *inside* the deadband.  The
      controller remembers the highest bound observed to overrun and
      never tightens back to it, which turns the cliff's edge into a
      stable fixed point (one step above the last overrun).

    Bounds never exit ``[floor, ceiling]``; moves respect
    ``cooldown_ticks``; fewer than ``min_checks`` checks in the window
    means abstain.  ``converged`` after ``settle_ticks`` consecutive
    evidence-bearing ticks without a move."""

    def __init__(self, op: str, tenant: str = "*", *,
                 rel_bound: float,
                 config: ControllerConfig = ControllerConfig()):
        cfg = config
        self.op = op
        self.tenant = tenant
        self.config = cfg
        self.rel_bound = min(max(float(rel_bound), cfg.floor), cfg.ceiling)
        self.tick_count = 0
        self.adjustments = 0
        self.ticks_to_converge: Optional[int] = None
        self._last_move_tick = -cfg.cooldown_ticks - 1
        self._ticks_without_move = 0
        #: highest bound observed to overrun the budget (cliff memory)
        self._overrun_bound = 0.0

    @property
    def converged(self) -> bool:
        return self._ticks_without_move >= self.config.settle_ticks

    def evidence_window(self) -> int:
        """The estimator window (in ticks) for the *next* tick: capped
        at ``window_ticks`` and at ticks-since-last-move, so decisions
        never rest on flags measured against a superseded bound.
        Before the first move the seed bound has been in effect the
        whole time, so the full window applies."""
        if self.adjustments == 0:
            return self.config.window_ticks
        fresh = self.tick_count + 1 - self._last_move_tick
        return max(1, min(self.config.window_ticks, fresh))

    def tick(self, estimate: dict) -> Optional[float]:
        """One evaluation tick; returns the new bound iff it moved."""
        cfg = self.config
        self.tick_count += 1
        if int(estimate.get("checks", 0)) < cfg.min_checks:
            return None                       # abstain: thin evidence
        lo = float(estimate.get("flag_rate_low", 0.0))
        hi = float(estimate.get("flag_rate_high", 1.0))
        moved = None
        if self.tick_count - self._last_move_tick > cfg.cooldown_ticks:
            if lo > cfg.fp_budget and self.rel_bound < cfg.ceiling:
                self._overrun_bound = max(self._overrun_bound,
                                          self.rel_bound)
                moved = min(cfg.ceiling, self.rel_bound * cfg.step)
            elif (hi < cfg.fp_budget * cfg.hysteresis
                  and self.rel_bound > cfg.floor
                  and self.rel_bound / cfg.step
                  > self._overrun_bound * (1.0 + 1e-9)):
                moved = max(cfg.floor, self.rel_bound / cfg.step)
        if moved is None:
            self._ticks_without_move += 1
            if self.converged and self.ticks_to_converge is None:
                self.ticks_to_converge = self.tick_count
            return None
        self.rel_bound = moved
        self.adjustments += 1
        self._last_move_tick = self.tick_count
        self._ticks_without_move = 0
        self.ticks_to_converge = None         # drift restarts the clock
        return moved

    def summary(self) -> dict:
        return {"op": self.op, "tenant": self.tenant,
                "rel_bound": self.rel_bound,
                "adjustments": self.adjustments,
                "converged": self.converged,
                "ticks_to_converge": self.ticks_to_converge,
                "ticks": self.tick_count,
                "overrun_bound": self._overrun_bound}


class AdaptiveThresholds:
    """The per-run manager: controllers keyed by (op, tenant), ticked
    from a Monitor, every move a typed ``threshold`` event.

    Live emission per adjustment (mirrored exactly by
    :func:`repro_torch.obs.replay`):

    * ``repro_threshold_adjustments_total{op,tenant,direction}`` +1;
    * ``repro_threshold_rel_bound{op,tenant}`` gauge set to the new
      bound;
    * a zero-duration tracer span ``threshold:<op>``;
    * one ``threshold`` :class:`~repro_torch.obs.FaultEvent` carrying the new
      bound as ``detector_value``, the old as ``bound``, and the
      estimate snapshot in ``attrs``.
    """

    def __init__(self, *, config: ControllerConfig = ControllerConfig(),
                 obs=None, source: str = "adapt.controller"):
        self.config = config
        self.source = source
        self.controllers: Dict[Tuple[str, str], ThresholdController] = {}
        self._obs = obs

    def bind(self, obs) -> "AdaptiveThresholds":
        self._obs = obs
        return self

    def manage(self, op: str, tenant: str = "*", *,
               rel_bound: Optional[float] = None,
               config: Optional[ControllerConfig] = None
               ) -> ThresholdController:
        """Get-or-create the (op, tenant) controller.  ``rel_bound``
        seeds the initial bound (e.g. from
        :func:`calibrate_from_sweep`); ``None`` falls back to the op's
        registered default threshold."""
        key = (op, tenant)
        if key not in self.controllers:
            if rel_bound is None:
                rel_bound = _op_default_bound(op)
            self.controllers[key] = ThresholdController(
                op, tenant, rel_bound=rel_bound,
                config=config or self.config)
        return self.controllers[key]

    def tick(self, monitor, *, t_s: float = 0.0, step: int = 0
             ) -> Dict[Tuple[str, str], float]:
        """One evaluation tick over every controller; returns the moved
        (op, tenant) -> new bound map (empty = no recompiles needed)."""
        moved: Dict[Tuple[str, str], float] = {}
        for (op, tenant), c in self.controllers.items():
            est = monitor.estimate(op=op, tenant=tenant,
                                   window_ticks=c.evidence_window())
            old = c.rel_bound
            new = c.tick(est)
            if new is not None:
                moved[(op, tenant)] = new
                self._emit_threshold(c, old, new, est, t_s=t_s, step=step)
        return moved

    def summary(self) -> List[dict]:
        return [c.summary() for c in self.controllers.values()]

    def _emit_threshold(self, c: ThresholdController, old: float,
                        new: float, est: dict, *, t_s: float,
                        step: int) -> None:
        obs = self._obs
        if obs is None:
            return
        from repro_torch.obs.events import FaultEvent
        direction = "raise" if new > old else "lower"
        obs.registry.counter(
            ADJUSTMENTS_COUNTER,
            "threshold-controller moves by op, tenant, and direction"
        ).inc(1, op=c.op, tenant=c.tenant, direction=direction)
        obs.registry.gauge(
            REL_BOUND_GAUGE,
            "current adaptive rel_bound per op and tenant").set(
                new, op=c.op, tenant=c.tenant)
        obs.tracer.add_span(f"threshold:{c.op}", cat="adapt",
                            start_s=t_s, dur_s=0.0, tenant=c.tenant,
                            direction=direction)
        obs.bus.emit(FaultEvent(
            op=c.op, step=step, source=self.source, kind="threshold",
            t_s=t_s, errors=int(est.get("errors", 0)),
            checks=int(est.get("checks", 0)),
            detector_value=new, bound=old,
            attrs={"tenant": c.tenant, "direction": direction,
                   "flag_rate": float(est.get("flag_rate", 0.0)),
                   "fp_budget": c.config.fp_budget,
                   "tick": c.tick_count, "converged": c.converged}))


def _op_default_bound(op: str) -> float:
    """The op adapter's static default threshold (the controller's seed
    when no calibration artifact is supplied)."""
    try:
        from repro_torch.protect.ops import get_op
        d = getattr(get_op(op), "default_rel_bound", None)
        if d is not None:
            return float(d)
    except (KeyError, ImportError):
        pass
    from repro_torch.core.abft_embedding import EB_REL_BOUND
    return float(EB_REL_BOUND)


def calibrate_from_sweep(artifact, *, fp_budget: float,
                         band: str = "*",
                         target: str = "embedding_bag") -> float:
    """Seed ``rel_bound`` from a ``--grid thresholds`` sweep artifact.

    ``artifact`` is a loaded artifact dict or a path to one.  Among the
    sweep points (restricted to ``band`` unless ``"*"``) whose measured
    FP rate is within ``fp_budget``, pick the smallest ``rel_bound`` —
    the tightest constant that held the budget offline, i.e. maximum
    detection.  If no point holds the budget, return the point with the
    lowest FP rate (the controller will loosen from there)."""
    import fnmatch

    from repro_torch.campaign.artifacts import (load_artifact,
                                                threshold_curve)
    if isinstance(artifact, str):
        artifact = load_artifact(artifact)
    curve = threshold_curve(artifact, target=target)
    points = [p for b, pts in curve.items()
              if fnmatch.fnmatch(b, band) for p in pts]
    if not points:
        raise ValueError(f"no {target!r} sweep points matching band "
                         f"{band!r} in artifact")
    within = [p for p in points if p[2] <= fp_budget]
    if within:
        return min(p[0] for p in within)
    return min(points, key=lambda p: p[2])[0]


__all__ = ["ControllerConfig", "VarianceModel", "ThresholdController",
           "AdaptiveThresholds", "calibrate_from_sweep",
           "ADJUSTMENTS_COUNTER", "REL_BOUND_GAUGE"]
