"""``serving_soak``: fault injection under live traffic, as a campaign (the
JAX package's ``serving/soak.py``).

Each cell runs the full serving engine twice over the SAME seeded request
stream — once clean, once with bit flips injected at chosen steps of the
live trace — and reduces the two telemetry timelines into
campaign-artifact metrics:

* ``detection_rate`` / ``escape_rate`` — per injected fault, was it
  flagged online (first flagged step at-or-after the injection), and did
  it corrupt any request's output tokens against the clean run (greedy
  decode over a seeded stream is deterministic, so token-for-token
  comparison is the masked/SDC ground truth);
* ``fp_rate`` — flagged steps in the clean run, per step (the serving
  analogue of the operator campaigns' clean-trial column);
* per-tenant SLO percentiles (p50/p95/p99 TTFT, per-token, e2e) for both
  runs plus the faulty-over-clean p99 degradation.

Cells sweep the arrival pattern (Poisson vs bursty) and, in the full
grid, the injected victim path.  Artifacts are ordinary
``BENCH_campaign_serving_soak.json`` files in the JAX schema, so the
differs of both packages read them.  The engines' clock is hybrid
(service time is step wall time), so on another machine admission can
batch the stream differently: at a burst rate (every arrival in the
first step) a cell is the same on either package; at the specs' 200 rps
rates are compared by Wilson interval.  With ``obs`` the faulty pass runs
instrumented and each cell's outcome lands as counters and a ``cell``
event; ``monitor`` watches the faulty passes.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

SOAK_ARCH = "llama3.2-1b"

#: the default multi-tenant mix: a premium class with retry-on-detect,
#: checksummed int8 KV cache and a tight EB threshold, and a best-effort
#: class with log-only protection — per-tenant plans exercised end to end.
DEFAULT_TENANTS: Tuple[Tuple[str, float, str], ...] = (
    ("premium", 1.0,
     "*:policy=recompute,kv_cache:on,embedding_bag:rel_bound=1e-5"),
    ("standard", 2.0, "*:policy=log"),
)


@dataclasses.dataclass(frozen=True)
class SoakSpec:
    """The sweep description embedded in the artifact."""
    name: str
    arch: str
    arrivals: Tuple[str, ...]
    n_requests: int
    n_slots: int
    rate_rps: float
    max_new_tokens: int
    seed: int
    tenants: Tuple[Tuple[str, float, str], ...] = DEFAULT_TENANTS
    victims: Tuple[Optional[str], ...] = (None,)
    persistent: bool = False

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class SoakCellPlan:
    cell_id: str
    target: str
    arrival: str
    arch: str
    n_requests: int
    n_slots: int
    rate_rps: float
    inject_steps: Tuple[int, ...]
    victim: Optional[str]
    persistent: bool
    seed: int
    #: (name, weight, plan_text) triples — the cell is self-contained
    tenants: Tuple[Tuple[str, float, str], ...] = DEFAULT_TENANTS

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class SoakMetrics:
    """Dict-backed metrics (campaign artifacts just need ``to_dict``)."""

    def __init__(self, d: dict):
        self._d = d

    def to_dict(self) -> dict:
        return self._d

    def __getitem__(self, k):
        return self._d[k]


def _tenant_specs(tenants=DEFAULT_TENANTS):
    from repro_torch.protect import ProtectionPlan
    from repro_torch.serving.engine import TenantSpec

    # from_any: compact strings, plan dicts, and @path.json all work —
    # the campaign CLI's --plan override passes through unparsed
    return [TenantSpec(name=n, weight=w,
                       plan=ProtectionPlan.from_any(p, name=n))
            for n, w, p in tenants]


def build_engine(arch: str, tenants, n_slots: int, max_new_tokens: int,
                 seed: int, device="cuda"):
    """The soak's engine: the reduced ``arch`` on ``device``, one lane a
    tenant plan."""
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.serving.engine import ServingEngine

    return ServingEngine(reduce_cfg(get_arch(arch)), _tenant_specs(tenants),
                         n_slots=n_slots, max_prompt=32,
                         max_new_tokens=max_new_tokens, seed=seed,
                         device=device)


def _token_map(telemetry) -> Dict[int, tuple]:
    return {r.rid: (tuple(r.tokens or ()), r.aborted)
            for r in telemetry.requests}


def _slo_of(summary: dict) -> dict:
    return {t: {"ttft_ms": s["ttft_ms"], "per_token_ms": s["per_token_ms"],
                "e2e_ms": s["e2e_ms"], "completed": s["completed"],
                "aborted": s["aborted"]}
            for t, s in summary["per_tenant"].items()}


def _degradation(clean: dict, faulty: dict) -> dict:
    out = {}
    for t in faulty:
        c = clean.get(t, {}).get("ttft_ms", {}).get("p99", float("nan"))
        f = faulty[t]["ttft_ms"]["p99"]
        out[t] = {"ttft_p99_ratio":
                  (f / c if c and np.isfinite(c) and c > 0
                   else float("nan"))}
    return out


def _publish_soak_cell(obs, plan: SoakCellPlan, metrics: "SoakMetrics",
                       injected: List[dict]) -> None:
    """Land the cell's outcome in the obs registry + event bus.

    Counters mirror the artifact's SoakMetrics exactly (detections =
    flagged injections, false positives = clean-pass flags) so the
    Prometheus text and the JSON artifact can be cross-checked; the
    per-step/per-op detection events were already emitted live by the
    engine during the faulty pass."""
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
    reg.counter("repro_escapes_total",
                "corrupted-and-undetected faults per campaign cell"
                ).inc(metrics["escapes"], cell=cell)
    reg.counter("repro_false_positives_total",
                "clean-pass flags per campaign cell"
                ).inc(metrics["false_positives"], cell=cell)
    for inj in injected:
        reg.counter("repro_injections_total",
                    "injected faults per campaign cell"
                    ).inc(1, source="serving.soak")
        obs.bus.emit(FaultEvent(
            op=inj.get("victim") or "auto", kind="injection",
            step=inj["step"], source="serving.soak",
            cell_id=plan.cell_id, errors=int(bool(inj["detected"])),
            checks=1, request_ids=tuple(inj.get("attributed_rids", ())),
            attrs={"detected": inj["detected"],
                   "latency_steps": inj["latency_steps"],
                   "persistent": plan.persistent}))
    obs.bus.emit(FaultEvent(
        op=plan.target, kind="cell", step=0, source="serving.soak",
        cell_id=plan.cell_id, errors=metrics["detected"],
        checks=metrics["samples"],
        detector_value=metrics["detection_rate"],
        attrs={"escapes": metrics["escapes"],
               "false_positives": metrics["false_positives"],
               "fp_rate": metrics["fp_rate"]}))


def run_soak_cell(plan: SoakCellPlan, *, engine=None,
                  keep_telemetry: bool = False, device="cuda", obs=None,
                  monitor=None) -> dict:
    """One cell: clean pass + faulty pass over the same stream.

    Returns ``{"plan", "metrics", "seconds"[, "telemetry"]}``; pass a
    prebuilt ``engine`` (same arch/tenants) to reuse it across cells.
    With ``obs``, the FAULTY pass runs instrumented (per-step detection
    events with resident request ids, spans, step counters) and the cell
    outcome lands as campaign-level counters; the clean pass stays
    uninstrumented so its flags count only as the cell's false-positive
    column, not as detection events."""
    from repro_torch.serving.engine import FaultInjection, tenant_weights
    from repro_torch.serving.workload import chat_stream

    t0 = time.perf_counter()
    specs = _tenant_specs(plan.tenants)
    if engine is None:
        engine = build_engine(plan.arch, plan.tenants, plan.n_slots, 16,
                              plan.seed, device)
    stream = chat_stream(
        plan.n_requests, tenants=tenant_weights(specs),
        rate_rps=plan.rate_rps, arrival=plan.arrival, seed=plan.seed,
        mean_prompt=24, max_prompt=32, mean_output=8,
        max_output=engine.max_new_tokens)

    engine.reset_state()
    clean = engine.run(stream)
    clean_summary = clean.summary()
    clean_steps = len(clean.steps)
    clean_flags = len(clean.detection_steps())

    engine.reset_state()
    injections = [FaultInjection(step=s, victim=plan.victim,
                                 persistent=plan.persistent,
                                 seed=plan.seed + 17 * i)
                  for i, s in enumerate(plan.inject_steps)]
    faulty = engine.run(stream, inject=injections, obs=obs,
                        monitor=monitor)
    engine.reset_state()          # restores any persistent fault
    faulty_summary = faulty.summary()

    clean_toks, faulty_toks = _token_map(clean), _token_map(faulty)
    corrupted_rids = [rid for rid in faulty_toks
                      if faulty_toks[rid] != clean_toks.get(rid)]
    injected = faulty_summary["faults"]["injections"]
    detected = sum(1 for i in injected if i["detected"])
    samples = max(len(injected), 1)
    # per-fault escape accounting: with one fault per run-slice the
    # stream-level "any token changed & nothing flagged" is the SDC bit
    escapes = sum(1 for i in injected
                  if not i["detected"]) if corrupted_rids else 0

    slo_clean = _slo_of(clean_summary)
    slo_faulty = _slo_of(faulty_summary)
    metrics = SoakMetrics({
        "samples": len(injected),
        "detected": detected,
        "corrupted": len(corrupted_rids),
        "escapes": escapes,
        "detection_rate": detected / samples,
        "escape_rate": escapes / samples,
        "clean_samples": clean_steps,
        "false_positives": clean_flags,
        "fp_rate": clean_flags / clean_steps if clean_steps else 0.0,
        "analytic_bound": None,
        "overhead": None,
        "detection_latency_steps": [i["latency_steps"] for i in injected],
        "detection_latency_ms": [
            None if i["latency_s"] is None else 1e3 * i["latency_s"]
            for i in injected],
        "injections": injected,
        "throughput_tok_s": faulty_summary["throughput_tok_s"],
        "queue_depth_max": faulty_summary["queue_depth_max"],
        "slo": slo_faulty,
        "slo_clean": slo_clean,
        "slo_degradation": _degradation(slo_clean, slo_faulty),
    })
    _publish_soak_cell(obs, plan, metrics, injected)
    out = {"plan": plan, "metrics": metrics,
           "seconds": time.perf_counter() - t0}
    if keep_telemetry:
        out["telemetry"] = {"clean": clean, "faulty": faulty}
    return out


def soak_plans(spec: SoakSpec) -> List[SoakCellPlan]:
    rng = np.random.default_rng(spec.seed)
    plans = []
    for arrival in spec.arrivals:
        for victim in spec.victims:
            # inject inside the early-traffic window every pattern reaches
            steps = tuple(sorted(int(s) for s in
                                 rng.integers(5, 30, size=1)))
            vic = victim if victim is None else str(victim)
            cid = f"serving_soak/{arrival}/" \
                  f"{vic or 'auto'}/{spec.arch}" \
                  + ("/persistent" if spec.persistent else "")
            plans.append(SoakCellPlan(
                cell_id=cid, target="serving_soak", arrival=arrival,
                arch=spec.arch, n_requests=spec.n_requests,
                n_slots=spec.n_slots, rate_rps=spec.rate_rps,
                inject_steps=steps, victim=victim,
                persistent=spec.persistent, seed=spec.seed,
                tenants=tuple(spec.tenants)))
    return plans


def quick_soak_spec(seed: int = 0, n_requests: int = 200) -> SoakSpec:
    return SoakSpec(name="serving_soak", arch=SOAK_ARCH,
                    arrivals=("poisson", "bursty"),
                    n_requests=n_requests, n_slots=4, rate_rps=200.0,
                    max_new_tokens=16, seed=seed)


def full_soak_spec(seed: int = 0) -> SoakSpec:
    return SoakSpec(name="serving_soak", arch=SOAK_ARCH,
                    arrivals=("poisson", "bursty"),
                    n_requests=400, n_slots=4, rate_rps=200.0,
                    max_new_tokens=16, seed=seed,
                    victims=(None, "attn.wq", "mlp.down"))


def run_soak_campaign(spec: Optional[SoakSpec] = None, *,
                      quick: bool = True, seed: int = 0,
                      out_dir: Optional[str] = None,
                      verbose=None, device="cuda", obs=None,
                      monitor=None) -> dict:
    """Run every cell of the spec on ``device``; returns (and optionally
    writes) the ``BENCH_campaign_serving_soak`` artifact dict."""
    from repro_torch.campaign.artifacts import (campaign_to_dict,
                                                write_artifacts)
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if spec is None:
        spec = quick_soak_spec(seed) if quick else full_soak_spec(seed)
    t0 = time.perf_counter()
    engine = build_engine(spec.arch, spec.tenants, spec.n_slots,
                          spec.max_new_tokens, spec.seed, dev)
    cells = []
    for plan in soak_plans(spec):
        cell = run_soak_cell(plan, engine=engine, obs=obs,
                             monitor=monitor)
        cells.append(cell)
        if verbose:
            m = cell["metrics"]
            verbose(f"[{plan.cell_id}] inj={m['samples']} "
                    f"detect={m['detection_rate']:.2f} "
                    f"escape={m['escape_rate']:.2f} "
                    f"fp={m['fp_rate']:.4f} ({cell['seconds']:.1f}s)")
    result = campaign_to_dict("serving_soak", [spec], cells, [],
                              wall_s=time.perf_counter() - t0,
                              seed=spec.seed, device=dev)
    if out_dir is not None:
        write_artifacts(result, out_dir)
    return result


__all__ = ["SoakSpec", "SoakCellPlan", "SoakMetrics", "run_soak_cell",
           "soak_plans", "run_soak_campaign", "quick_soak_spec",
           "full_soak_spec", "build_engine", "DEFAULT_TENANTS", "SOAK_ARCH"]
