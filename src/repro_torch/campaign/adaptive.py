"""``--grid adaptive``: controller-convergence cells under drifting
workloads (the JAX package's ``campaign/adaptive.py``).

Each cell drives the :class:`repro_torch.adapt.ThresholdController` loop
end-to-end against a synthetic EmbeddingBag stream: per evaluation tick
it computes the Eq. (5) residual *ratio* ``|rsum - csum| / max(mag, 1)``
per bag on the device (the pieces of ``abft_embedding_bag``, which does
not expose the raw residual), then compares host-side against the
controller's evolving ``rel_bound``.  Because the bound lives host-side,
threshold moves rebuild nothing here, and the best-offline-static
comparison replays the *identical* ratio stream against every candidate
constant — an exact apples-to-apples detection comparison on the same
workload.

The ratio stream is plain PyTorch on the cell's device, as the JAX
module's is plain ``jnp`` (no Pallas kernel).  Its draws (the table, the
bags, each trial's flipped element and bit) are the JAX module's own:
:mod:`repro_torch.campaign.prng` draws ``jax.random``'s Threefry stream
for the same keys on the host, so a cell of the port reads the table,
bags and flips its JAX counterpart reads.  Its sums take one fixed
order of elementwise float32 adds (:func:`lane_sum`), so the card and
the CPU compute the same ratios bit for bit.  The ticks' clock is
synthetic (``t_s = 0.01 × (tick + 1)``).

Mid-stream each cell drifts the workload:

* ``variance_shift`` — the accumulation dtype switches f32 → bf16
  (mixed-precision serving), inflating the clean-residual distribution
  ~1000×: the controller must loosen fast or drown in false positives;
* ``prompt_mix`` — the valid-slots-per-bag mix collapses (long prompts →
  short), shrinking accumulated round-off: the controller should tighten
  and buy detection back;
* ``bursty`` — arrivals turn bursty (0–4 batches per tick, idle ticks
  included): the evidence rate varies wildly and the windowed estimator
  plus ``min_checks`` abstention must keep the loop stable.

Cell gates:

* ``converged`` within the stream and re-converged after the drift;
* ``fp_budget_held`` — post-convergence realized FP is not statistically
  above the budget (Wilson lower bound <= budget);
* ``detection_ok`` — stream-wide detection >= the best offline-swept
  constant that holds the same budget on the same stream.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.adapt import AdaptiveThresholds, ControllerConfig
from repro_torch.campaign import prng
from repro_torch.campaign.metrics import wilson_interval

ADAPT_OP = "embedding_bag"
ADAPT_TENANT = "premium"

#: drift kinds a spec can sweep (see module docstring)
DRIFTS = ("variance_shift", "prompt_mix", "bursty")


@dataclasses.dataclass(frozen=True)
class AdaptiveSpec:
    """The sweep description embedded in the artifact."""
    name: str
    drifts: Tuple[str, ...]
    shape: Tuple[int, int, int, int]      # rows, dim, bags, pool
    steps: int                            # evaluation ticks per cell
    drift_at: int                         # tick the workload shifts
    fp_budget: float
    seed: int
    #: ControllerConfig fields (kept as pairs so the spec serializes)
    controller: Tuple[Tuple[str, float], ...] = ()

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def controller_config(self) -> ControllerConfig:
        return ControllerConfig(fp_budget=self.fp_budget,
                                **dict(self.controller))


@dataclasses.dataclass(frozen=True)
class AdaptiveCellPlan:
    cell_id: str
    target: str
    kind: str                             # "adaptive" (schema dispatch)
    drift: str
    shape: Tuple[int, int, int, int]
    steps: int
    drift_at: int
    fp_budget: float
    seed: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class AdaptiveMetrics:
    """Dict-backed metrics (campaign artifacts just need ``to_dict``)."""

    def __init__(self, d: dict):
        self._d = d

    def to_dict(self) -> dict:
        return self._d

    def __getitem__(self, k):
        return self._d[k]


# ------------------------------ device side ---------------------------------


def regime(k: np.ndarray, shape, device) -> dict:
    """The trained-table regime the operator campaign uses: int8 rows,
    per-row dequant scales in [0.01, 0.02) and offsets in [0.3, 0.7),
    exact int32 rowsums; drawn from key ``k`` as the JAX module draws
    them."""
    from repro_torch.core.abft_embedding import table_rowsums

    rows, dim, _, _ = shape
    k1, k2, k3 = prng.split(k, 3)
    state = {"table": prng.randint(k1, (rows, dim), -127, 128, np.int8),
             "alphas": prng.uniform(k2, (rows,), 0.01, 0.02),
             "betas": prng.uniform(k3, (rows,), 0.3, 0.7)}
    state = {n: torch.from_numpy(v).to(device) for n, v in state.items()}
    state["rowsums"] = table_rowsums(state["table"])
    return state


def lane_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Sum float32 ``x`` over ``dim`` in one fixed order of elementwise
    adds: eight lane accumulators over consecutive blocks of eight, then
    halving (XLA's CPU order for the slot sums).  Every device computes
    the same bits."""
    x = x.movedim(dim, -1)
    n = x.shape[-1]
    if n % 8:
        x = torch.cat([x, x.new_zeros(*x.shape[:-1], 8 - n % 8)], dim=-1)
    x = x.reshape(*x.shape[:-1], -1, 8)
    s = x[..., 0, :]
    for k in range(1, x.shape[-2]):
        s = s + x[..., k, :]
    while s.shape[-1] > 1:
        h = s.shape[-1] // 2
        s = s[..., :h] + s[..., h:]
    return s[..., 0]


def ratios(state: dict, table: torch.Tensor, idx: torch.Tensor,
           acc_dtype: torch.dtype) -> torch.Tensor:
    """The Eq. (5) residual ratio ``|rsum - csum| / max(mag, 1)`` of each
    bag of ``idx`` ([bags, pool], ``-1`` padding) over ``table``, the
    dequantized terms in ``acc_dtype`` and each sum rounded to it
    (float32 [bags]).  ``α·C_T + d·β`` is rounded once, as XLA fuses it
    (the float64 product and sum are exact)."""
    valid = idx >= 0
    safe = torch.where(valid, idx, 0).long()
    dim = table.shape[1]
    trows = table[safe].to(acc_dtype)
    a = state["alphas"][safe]
    b = state["betas"][safe]
    w = valid.to(torch.float32)
    deq = a[..., None].to(acc_dtype) * trows + b[..., None].to(acc_dtype)
    terms = (w[..., None].to(acc_dtype) * deq).float()
    r = lane_sum(terms, 1).to(acc_dtype).float()
    rsum = lane_sum(r, -1).to(acc_dtype).float()
    ct = state["rowsums"][safe].to(torch.float32)
    fused = (a.double() * ct.double() + (dim * b).double()).float()
    csum = lane_sum(w * fused, -1)
    mag = lane_sum(w.abs() * (a.abs() * ct.abs() + dim * b.abs()), -1)
    return (rsum - csum).abs() / torch.clamp(mag, min=1.0)


def draw_bags(k: np.ndarray, shape, n_valid: int) -> torch.Tensor:
    """One batch of bags from key ``k``: ``n_valid`` live slots a bag,
    the rest ``-1``."""
    rows, _, bags, pool = shape
    live = torch.from_numpy(prng.randint(k, (bags, n_valid), 0, rows))
    pad = torch.full((bags, pool - n_valid), -1, dtype=torch.int32)
    return torch.cat([live, pad], dim=1)


def trial_ratios(state: dict, idx: torch.Tensor, bag: int, slot: int,
                 col: int, bit: int, acc_dtype: torch.dtype
                 ) -> torch.Tensor:
    """:func:`ratios` with bit ``bit`` of table element ``(idx[bag, slot],
    col)`` flipped (in place, and flipped back after): every bag reading
    that row sees the flip; the rowsums stay clean."""
    table = state["table"]
    row = idx[bag, slot].to(table.device).long()
    mask = (1 << bit) if bit < 7 else -128
    table[row, col] ^= mask
    try:
        return ratios(state, table, idx, acc_dtype)
    finally:
        table[row, col] ^= mask


class RatioStream:
    """One workload regime's (clean, trial) residual-ratio draws: each
    draws its own bags from its key; a trial additionally flips one
    random bit of one gathered table element (the operator campaign's
    fault model; a bit flip always changes its element)."""

    def __init__(self, state: dict, shape, n_valid: int, acc_dtype,
                 device):
        self.state, self.shape = state, shape
        self.n_valid, self.acc_dtype = n_valid, acc_dtype
        self.device = device

    def clean(self, k: np.ndarray) -> np.ndarray:
        idx = draw_bags(k, self.shape, self.n_valid).to(self.device)
        return ratios(self.state, self.state["table"], idx,
                      self.acc_dtype).cpu().numpy().astype(np.float64)

    def trial(self, k: np.ndarray) -> np.ndarray:
        _, dim, bags, _ = self.shape
        ki, kb, kp, kc, kbit = prng.split(k, 5)
        idx = draw_bags(ki, self.shape, self.n_valid)
        bag, slot, col, bit = (int(prng.randint(kk, (), 0, hi)) for kk, hi
                               in ((kb, bags), (kp, self.n_valid),
                                   (kc, dim), (kbit, 8)))
        out = trial_ratios(self.state, idx.to(self.device), bag, slot, col,
                           bit, self.acc_dtype)
        return out.cpu().numpy().astype(np.float64)


def drift_regimes(drift: str, shape):
    """(n_valid, acc_dtype) for the pre- and post-drift workloads."""
    _, _, _, pool = shape
    full, quarter = pool, max(pool // 4, 1)
    if drift == "variance_shift":
        return (full, torch.float32), (full, torch.bfloat16)
    if drift == "prompt_mix":
        return (full, torch.float32), (quarter, torch.float32)
    if drift == "bursty":
        return (full, torch.float32), (full, torch.float32)
    raise ValueError(f"unknown drift {drift!r}; have {DRIFTS}")


def batches_per_tick(drift: str, steps: int, seed: int) -> List[int]:
    """The arrival schedule: 1 batch/tick, except the ``bursty`` drift's
    post-drift half draws 0–4 (0 = an idle tick), from numpy's generator
    at the cell's seed as the JAX module draws it."""
    if drift != "bursty":
        return [1] * steps
    rng = np.random.default_rng(seed)
    half = steps // 2
    return [1] * half + [int(b) for b in
                         rng.choice([0, 1, 2, 4], size=steps - half,
                                    p=[0.25, 0.35, 0.25, 0.15])]


# ------------------------------ the cell ------------------------------------


def run_adaptive_cell(plan: AdaptiveCellPlan, *,
                      config: ControllerConfig, obs=None,
                      device="cuda") -> dict:
    """One convergence cell: drive the controller over the drifting
    stream, then replay the stored ratio stream against a static-bound
    ladder for the best-offline-constant comparison."""
    from repro_torch.device import resolve_device
    from repro_torch.obs import Monitor

    dev = resolve_device(device)
    t0 = time.perf_counter()
    monitor = Monitor(rules=())       # pure sensor: no alert rules
    if obs is not None:
        monitor.bind(obs)
    adapt = AdaptiveThresholds(config=config, obs=obs,
                               source="campaign.adaptive")
    ctrl = adapt.manage(ADAPT_OP, ADAPT_TENANT, rel_bound=None)

    (nv_a, dt_a), (nv_b, dt_b) = drift_regimes(plan.drift, plan.shape)
    state = regime(prng.key(plan.seed), plan.shape, dev)
    stream_a = RatioStream(state, plan.shape, nv_a, dt_a, dev)
    stream_b = RatioStream(state, plan.shape, nv_b, dt_b, dev)
    schedule = batches_per_tick(plan.drift, plan.steps, plan.seed)

    clean_ratios: List[np.ndarray] = []      # per clean batch
    trial_ratios_: List[np.ndarray] = []     # per injected trial
    trial_bounds: List[float] = []           # bound active at the trial
    fp_by_tick: List[Tuple[int, int, int]] = []  # (tick, fps, checks)
    move_ticks: List[int] = []

    base = prng.key(plan.seed + 1)
    step_i = 0
    for tick, n_batches in enumerate(schedule):
        stream = stream_a if tick < plan.drift_at else stream_b
        t_s = 0.01 * (tick + 1)
        if n_batches == 0:
            monitor.idle_tick(t_s)
            adapt.tick(monitor, t_s=t_s, step=tick)
            continue
        fps = checks = 0
        for _ in range(n_batches):
            rc = stream.clean(prng.fold_in(base, 2 * step_i))
            rt = stream.trial(prng.fold_in(base, 2 * step_i + 1))
            step_i += 1
            clean_ratios.append(rc)
            trial_ratios_.append(rt)
            trial_bounds.append(ctrl.rel_bound)
            fps += int(np.sum(rc > ctrl.rel_bound))
            checks += rc.size
        fp_by_tick.append((tick, fps, checks))
        monitor.record_step(t_s, {ADAPT_OP: (checks, fps)},
                            tenants=(ADAPT_TENANT,))
        before = ctrl.adjustments
        adapt.tick(monitor, t_s=t_s, step=tick)
        if ctrl.adjustments > before:
            move_ticks.append(tick)

    # ---- adaptive-run detection/FP over the whole stream ----
    corrupted = len(trial_ratios_)            # every flip changes its byte
    detected = sum(1 for rt, b in zip(trial_ratios_, trial_bounds)
                   if bool(np.any(rt > b)))
    total_checks = sum(c for _, _, c in fp_by_tick)
    total_fps = sum(f for _, f, _ in fp_by_tick)

    # ---- post-convergence realized FP (the budget-held gate) ----
    last_move = move_ticks[-1] if move_ticks else -1
    post = [(f, c) for t, f, c in fp_by_tick if t > last_move]
    post_fps = sum(f for f, _ in post)
    post_checks = sum(c for _, c in post)
    fp_lo, fp_hi = (wilson_interval(post_fps, post_checks)
                    if post_checks else (0.0, 1.0))
    realized = post_fps / post_checks if post_checks else 0.0
    budget_held = bool(ctrl.converged and fp_lo <= plan.fp_budget)

    # ---- best offline-swept constant on the identical stream ----
    ladder = np.geomspace(config.floor, config.ceiling, 33)
    best_rb, best_det, best_fp = None, -1.0, None
    all_clean = np.concatenate(clean_ratios) if clean_ratios else \
        np.zeros(0)
    for t in ladder:
        fp_t = float(np.mean(all_clean > t)) if all_clean.size else 0.0
        if fp_t > plan.fp_budget:
            continue
        det_t = (sum(1 for rt in trial_ratios_ if bool(np.any(rt > t)))
                 / corrupted if corrupted else 0.0)
        if det_t > best_det:
            best_rb, best_det, best_fp = float(t), det_t, fp_t
    det_rate = detected / corrupted if corrupted else 0.0
    detection_ok = bool(det_rate + 1e-12 >= best_det)

    metrics = AdaptiveMetrics({
        "samples": len(trial_ratios_),
        "corrupted": corrupted,
        "detected": detected,
        "escapes": corrupted - detected,
        "escape_rate": ((corrupted - detected) / corrupted
                        if corrupted else 0.0),
        "detection_rate": det_rate,
        "clean_samples": total_checks,
        "false_positives": total_fps,
        "fp_rate": total_fps / total_checks if total_checks else 0.0,
        "fp_budget": plan.fp_budget,
        "realized_fp_rate": realized,
        "realized_fp_low": fp_lo,
        "realized_fp_high": fp_hi,
        "fp_budget_held": budget_held,
        "fp_budget_in_ci": bool(fp_lo <= plan.fp_budget <= fp_hi),
        "converged": bool(ctrl.converged),
        "converged_rel_bound": ctrl.rel_bound,
        "ticks_to_converge": ctrl.ticks_to_converge,
        "adjustments": ctrl.adjustments,
        "move_ticks": move_ticks,
        "best_static_rel_bound": best_rb,
        "best_static_detection": best_det if best_rb is not None
        else None,
        "best_static_fp": best_fp,
        "detection_ok": detection_ok,
        "overhead": None,
        "analytic_bound": None,
        "controller": ctrl.summary(),
    })
    _publish_adaptive_cell(obs, plan, metrics)
    return {"plan": plan, "metrics": metrics,
            "seconds": time.perf_counter() - t0}


def _publish_adaptive_cell(obs, plan: AdaptiveCellPlan,
                           metrics: AdaptiveMetrics) -> None:
    """Land the cell outcome as campaign counters + one ``cell`` event
    (the controller's own ``threshold`` events were emitted live)."""
    if obs is None:
        return
    from repro_torch.obs import FaultEvent

    reg = obs.registry
    cell = plan.cell_id
    reg.counter("repro_injections_total",
                "injected faults per campaign cell"
                ).inc(metrics["samples"], cell=cell)
    reg.counter("repro_detections_total",
                "online-detected injected faults per campaign cell"
                ).inc(metrics["detected"], cell=cell)
    reg.counter("repro_false_positives_total",
                "clean-pass flags per campaign cell"
                ).inc(metrics["false_positives"], cell=cell)
    obs.bus.emit(FaultEvent(
        op=plan.target, kind="cell", step=0,
        source="campaign.adaptive", cell_id=cell,
        errors=metrics["detected"], checks=metrics["samples"],
        detector_value=metrics["detection_rate"],
        bound=metrics["converged_rel_bound"],
        attrs={"false_positives": metrics["false_positives"],
               "fp_rate": metrics["fp_rate"],
               "converged": metrics["converged"],
               "fp_budget_held": metrics["fp_budget_held"],
               "detection_ok": metrics["detection_ok"]}))


# ------------------------------ the grid ------------------------------------


def adaptive_plans(spec: AdaptiveSpec) -> List[AdaptiveCellPlan]:
    return [AdaptiveCellPlan(
        cell_id=f"adaptive/{drift}/eb{'x'.join(map(str, spec.shape))}"
                f"/fp{spec.fp_budget:g}",
        target="adaptive_eb", kind="adaptive", drift=drift,
        shape=spec.shape, steps=spec.steps, drift_at=spec.drift_at,
        fp_budget=spec.fp_budget, seed=spec.seed + i)
        for i, drift in enumerate(spec.drifts)]


#: controller tuning the campaign cells run with — wide clamp range so
#: the bf16 variance shift stays inside it; min_checks sized to two
#: ticks of fresh evidence (64 checks/tick) so a move's effect is
#: judged after one cooldown tick
CAMPAIGN_CONTROLLER: Tuple[Tuple[str, float], ...] = (
    ("floor", 1e-8), ("ceiling", 0.05), ("step", 1.35),
    ("hysteresis", 0.6), ("min_checks", 128), ("cooldown_ticks", 1),
    ("settle_ticks", 10), ("window_ticks", 24),
)


def quick_adaptive_spec(seed: int = 0) -> AdaptiveSpec:
    return AdaptiveSpec(name="adaptive_quick", drifts=DRIFTS,
                        shape=(128, 16, 64, 32), steps=240,
                        drift_at=120, fp_budget=0.02, seed=seed,
                        controller=CAMPAIGN_CONTROLLER)


def full_adaptive_spec(seed: int = 0) -> AdaptiveSpec:
    return AdaptiveSpec(name="adaptive", drifts=DRIFTS,
                        shape=(256, 32, 64, 32), steps=480,
                        drift_at=240, fp_budget=0.02, seed=seed,
                        controller=CAMPAIGN_CONTROLLER)


def run_adaptive_campaign(spec: Optional[AdaptiveSpec] = None, *,
                          quick: bool = True, seed: int = 0,
                          out_dir: Optional[str] = None,
                          verbose=None, obs=None, device="cuda") -> dict:
    """Run every drift cell on ``device``; returns (and optionally
    writes) the ``BENCH_campaign_adaptive[_quick]`` artifact dict."""
    from repro_torch.campaign.artifacts import (campaign_to_dict,
                                                write_artifacts)
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if spec is None:
        spec = quick_adaptive_spec(seed) if quick \
            else full_adaptive_spec(seed)
    t0 = time.perf_counter()
    config = spec.controller_config()
    cells = []
    for plan in adaptive_plans(spec):
        cell = run_adaptive_cell(plan, config=config, obs=obs, device=dev)
        cells.append(cell)
        if verbose:
            m = cell["metrics"]
            verbose(f"[{plan.cell_id}] converged={m['converged']} "
                    f"rb={m['converged_rel_bound']:.3g} "
                    f"moves={m['adjustments']} "
                    f"det={m['detection_rate']:.2f} "
                    f"(best static {m['best_static_detection']}) "
                    f"fp={m['realized_fp_rate']:.4f} "
                    f"budget_held={m['fp_budget_held']} "
                    f"({cell['seconds']:.1f}s)")
    result = campaign_to_dict(spec.name, [spec], cells, [],
                              wall_s=time.perf_counter() - t0,
                              seed=spec.seed, device=dev)
    if out_dir is not None:
        write_artifacts(result, out_dir)
    return result


__all__ = ["AdaptiveSpec", "AdaptiveCellPlan", "AdaptiveMetrics",
           "run_adaptive_cell", "adaptive_plans", "run_adaptive_campaign",
           "quick_adaptive_spec", "full_adaptive_spec", "regime", "ratios",
           "trial_ratios", "lane_sum", "draw_bags", "RatioStream",
           "DRIFTS", "ADAPT_OP", "ADAPT_TENANT", "CAMPAIGN_CONTROLLER"]
