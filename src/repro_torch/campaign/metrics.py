"""Per-cell campaign metrics (a copy of the JAX package's
``campaign/metrics.py``, so artifacts keep its schema).

Counting conventions (matching the paper's tables and the fault-injection
literature):

* ``detection_rate``   — detected OR masked, over all faulty trials: a
  fault that provably did not corrupt anything (``corrupted == False``)
  counts as handled, exactly as in benchmarks/ Table II reproduction;
* ``raw_detection_rate`` — flag actually raised, over all faulty trials;
* ``escape_rate``      — corrupted AND undetected (the SDC column);
* ``fp_rate``          — flags on clean runs;
* ``overhead``         — protected/unprotected wall-time ratio minus 1;
* ``ci95``             — Wilson interval on the effective detection rate
  (campaign cells run at modest sample counts; the interval keeps
  cross-PR comparisons honest).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple


def wilson_interval(k: int, n: int, z: float = 1.96) -> Tuple[float, float]:
    """95% Wilson score interval for k successes out of n."""
    if n == 0:
        return (0.0, 1.0)
    p = k / n
    denom = 1.0 + z * z / n
    center = (p + z * z / (2 * n)) / denom
    half = (z / denom) * math.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return (max(0.0, center - half), min(1.0, center + half))


@dataclasses.dataclass(frozen=True)
class CellMetrics:
    samples: int
    corrupted: int
    detected: int             # flag raised on faulty trials
    effective_detected: int   # detected | masked (fault didn't corrupt)
    escapes: int              # corrupted & undetected — the SDC count
    clean_samples: int
    false_positives: int
    detection_rate: float
    raw_detection_rate: float
    escape_rate: float
    fp_rate: float
    ci95: Tuple[float, float]
    analytic_bound: Optional[float] = None
    overhead: Optional[float] = None
    protected_s: Optional[float] = None
    unprotected_s: Optional[float] = None
    #: per-phase median wall seconds (quantize/encode/gemm/verify ... —
    #: phase names are target-specific); None when the cell didn't
    #: measure overhead or the target has no phase thunks
    overhead_breakdown: Optional[Dict[str, float]] = None
    # ------- multi-step soak columns (None for single-shot cells) -------
    #: steps per trial the cell actually ran
    steps: Optional[int] = None
    #: hist[t] = trials whose FIRST detection fired t steps after the
    #: upset — the per-step detection-latency histogram; undetected trials
    #: are not in the histogram (they are the escape/masked columns)
    detection_latency_hist: Optional[List[int]] = None
    #: mean of the histogram above (None when nothing was detected)
    mean_detection_latency: Optional[float] = None
    #: relative L2 parameter divergence from the clean twin run, over
    #: faulty trials (the training ground truth: how far did it drift)
    divergence_mean: Optional[float] = None
    divergence_max: Optional[float] = None
    #: max |loss_faulty - loss_clean| over the soak, averaged over trials
    loss_divergence_mean: Optional[float] = None
    # ------- multi-device soak columns (None for non-soak cells) --------
    #: data shards the cell actually executed under (may be lower than
    #: ``plan.data_shards`` when the host had fewer devices)
    shards: Optional[int] = None
    #: True iff ``checked_psum`` ran through a real shard_map collective
    #: at the PLANNED shard count (``shards == plan.data_shards > 1``) —
    #: the column that says the detection claim covers the distributed
    #: reduction the cell id promises; any degradation (partial or to
    #: the ``axis_name=None`` fallback) records False, with ``shards``
    #: holding what actually ran
    collective_verified: Optional[bool] = None
    #: shard_detections[s] = faulty trials whose receive-side payload
    #: verify fired on shard s (the per-shard FaultReport merge) —
    #: attribution telemetry; the detection verdict itself is the
    #: post-collective additivity check
    shard_detections: Optional[List[int]] = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["ci95"] = list(self.ci95)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "CellMetrics":
        d = dict(d)
        d["ci95"] = tuple(d["ci95"])
        return cls(**d)


def compute_metrics(*, samples: int, detected: int, corrupted: int,
                    detected_and_corrupted: int, clean_samples: int,
                    false_positives: int,
                    analytic_bound: Optional[float] = None,
                    protected_s: Optional[float] = None,
                    unprotected_s: Optional[float] = None,
                    overhead_breakdown: Optional[Dict[str, float]] = None,
                    steps: Optional[int] = None,
                    detection_latency_hist: Optional[List[int]] = None,
                    divergence_mean: Optional[float] = None,
                    divergence_max: Optional[float] = None,
                    loss_divergence_mean: Optional[float] = None,
                    shards: Optional[int] = None,
                    collective_verified: Optional[bool] = None,
                    shard_detections: Optional[List[int]] = None
                    ) -> CellMetrics:
    # |detected ∪ masked| = samples - |corrupted ∩ undetected|
    escapes = corrupted - detected_and_corrupted
    effective = samples - escapes
    overhead = None
    if protected_s is not None and unprotected_s and unprotected_s > 0:
        overhead = protected_s / unprotected_s - 1.0
    mean_latency = None
    if detection_latency_hist is not None:
        n_det = sum(detection_latency_hist)
        if n_det:
            mean_latency = sum(t * c for t, c in
                               enumerate(detection_latency_hist)) / n_det
    return CellMetrics(
        samples=samples,
        corrupted=corrupted,
        detected=detected,
        effective_detected=effective,
        escapes=escapes,
        clean_samples=clean_samples,
        false_positives=false_positives,
        detection_rate=effective / samples if samples else 0.0,
        raw_detection_rate=detected / samples if samples else 0.0,
        escape_rate=escapes / samples if samples else 0.0,
        fp_rate=(false_positives / clean_samples) if clean_samples else 0.0,
        ci95=wilson_interval(effective, samples),
        analytic_bound=analytic_bound,
        overhead=overhead,
        protected_s=protected_s,
        unprotected_s=unprotected_s,
        overhead_breakdown=overhead_breakdown,
        steps=steps,
        detection_latency_hist=detection_latency_hist,
        mean_detection_latency=mean_latency,
        divergence_mean=divergence_mean,
        divergence_max=divergence_max,
        loss_divergence_mean=loss_divergence_mean,
        shards=shards,
        collective_verified=collective_verified,
        shard_detections=shard_detections,
    )
