"""``paging``: the paged-KV serving campaign — parity, cost, and repair
(the JAX package's ``serving/paging_soak.py``).

Two cells, both over the same mixed-length two-tenant request stream
whose requests open with a shared system prompt (``prefix_len`` tokens
from one ``prefix_seed``):

* **parity** — the paged engine (``kv_cache_paged``) and the contiguous
  fixed-slot engine (``kv_cache``) each serve the stream clean once and
  then once per fault of the SAME KV bit-flip grid (one persistent int8
  payload flip per pass, same seeds/steps on both sides).  The cell
  records detection-rate parity (Wilson-interval overlap), the measured
  pages-verified-per-decode-token of the paged scheme against the
  contiguous whole-prefix re-verify (computed analytically: ``2*pos``
  row checksums per slot per decode step), and the paged pool's peak
  resident KV bytes against the fixed-slot ``max_prompt`` layout.
* **rebuild** — the paged engine under ``policy=recompute`` takes one
  persistent KV flip; detect→scrub→evict→re-prefill must repair it
  online (``page_rebuilds >= 1``) without aborting the stream.

Artifacts are ordinary ``BENCH_campaign_paging*.json`` files in the JAX
schema, so the differs of both packages read them; the extra
parity/cost booleans ride in the cell metrics; with ``obs`` each cell's
faulty passes run instrumented and its outcome lands as counters and a
``cell`` event.  The engines' clock is wall time, so on another machine admission can batch
the stream differently and the counts move; the gates are the four
booleans and Wilson overlap.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.campaign.metrics import wilson_interval

PAGING_ARCH = "llama3.2-1b"

#: detection-parity pair: same log-only policy, only the KV scheme moves
PAGED_PLAN = "*:policy=log,kv_cache_paged:on"
CONTIG_PLAN = "*:policy=log,kv_cache:on"
#: the repair cell's plan: detect -> evict corrupt page -> re-prefill
REBUILD_PLAN = "*:policy=recompute,kv_cache_paged:on"


@dataclasses.dataclass(frozen=True)
class PagingSoakSpec:
    """The sweep description embedded in the artifact."""
    name: str
    arch: str
    n_requests: int
    n_slots: int
    rate_rps: float
    max_new_tokens: int
    page_size: int
    n_pages: int
    prefix_len: int
    n_faults: int
    seed: int
    plan: str = PAGED_PLAN
    contig_plan: str = CONTIG_PLAN
    rebuild_plan: str = REBUILD_PLAN

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass(frozen=True)
class PagingCellPlan:
    cell_id: str
    target: str
    kind: str                        # "parity" | "rebuild"
    arch: str
    n_requests: int
    n_slots: int
    rate_rps: float
    page_size: int
    n_pages: int
    prefix_len: int
    inject_steps: Tuple[int, ...]
    seed: int
    plan: str

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class PagingMetrics:
    def __init__(self, d: dict):
        self._d = d

    def to_dict(self) -> dict:
        return self._d

    def __getitem__(self, k):
        return self._d[k]


def intervals_overlap(a: Tuple[float, float],
                      b: Tuple[float, float]) -> bool:
    return a[0] <= b[1] and b[0] <= a[1]


# ------------------------------ engines -------------------------------------

def _engines(spec: PagingSoakSpec, device):
    """(paged-log, contiguous, paged-rebuild) engines over two tenants
    sharing each plan — one lane, one shared page pool per engine."""
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.paging import PagingConfig
    from repro_torch.protect import ProtectionPlan
    from repro_torch.serving.engine import ServingEngine, TenantSpec

    cfg = reduce_cfg(get_arch(spec.arch))
    pcfg = PagingConfig(page_size=spec.page_size, n_pages=spec.n_pages)

    def build(plan_text: str, paging):
        plan = ProtectionPlan.from_any(plan_text, name="paging")
        tenants = [TenantSpec("tenant_a", plan),
                   TenantSpec("tenant_b", plan)]
        return ServingEngine(cfg, tenants, n_slots=spec.n_slots,
                             max_prompt=32,
                             max_new_tokens=spec.max_new_tokens,
                             seed=spec.seed, paging=paging, device=device)

    return (build(spec.plan, pcfg), build(spec.contig_plan, None),
            build(spec.rebuild_plan, pcfg))


def _stream(spec: PagingSoakSpec, engine):
    from repro_torch.serving.workload import chat_stream
    return chat_stream(
        spec.n_requests, tenants={"tenant_a": 1.0, "tenant_b": 1.0},
        rate_rps=spec.rate_rps, seed=spec.seed, mean_prompt=24,
        max_prompt=32, mean_output=8, max_output=engine.max_new_tokens,
        prefix_len=spec.prefix_len, prefix_seed=spec.seed + 0x5EED)


def _token_map(telemetry) -> Dict[int, tuple]:
    return {r.rid: (tuple(r.tokens or ()), r.aborted)
            for r in telemetry.requests}


def _decode_tokens(telemetry) -> int:
    """Decode tokens emitted = sum of occupancy over decode steps."""
    return sum(ev.occupancy for ev in telemetry.steps
               if ev.kind == "decode")


def _contig_compares_per_token(telemetry, max_prompt: int) -> float:
    """Analytic checksum compares per decode token of the contiguous
    whole-prefix re-verify: each decode step at absolute position
    ``pos`` verifies all ``pos`` written rows of K and of V."""
    compares = tokens = 0
    for r in telemetry.requests:
        if r.rejected or r.tokens_out <= 1:
            continue
        for g in range(1, r.tokens_out):
            compares += 2 * (max_prompt + g)
            tokens += 1
    return compares / tokens if tokens else 0.0


def _fault_grid(spec: PagingSoakSpec):
    """The shared bit-flip grid: (step, seed) per fault — the paged and
    contiguous passes replay the identical list."""
    rng = np.random.default_rng(spec.seed + 0xFA11)
    steps = sorted(int(s) for s in
                   rng.choice(np.arange(4, 28), size=spec.n_faults,
                              replace=False))
    return [(s, spec.seed + 17 * i) for i, s in enumerate(steps)]


def _tree_nbytes(tree) -> int:
    """Bytes of every tensor in a cache tree (dicts and named tuples), a
    view counted at its own size as a JAX array of its shape would be."""
    if isinstance(tree, dict):
        return sum(_tree_nbytes(v) for v in tree.values())
    if isinstance(tree, tuple):
        return sum(_tree_nbytes(v) for v in tree)
    return tree.numel() * tree.element_size()


def _fault_passes(engine, stream, grid, obs=None):
    """One clean pass + one faulty pass per grid entry; returns
    (clean_telemetry, clean-pass state snapshot, [per-fault dicts]).

    The snapshot (pager stats + resident cache bytes) is taken right
    after the clean pass — ``reset_state`` wipes pager counters and
    drops lane caches, so it cannot be read after the fault loop."""
    from repro_torch.serving.engine import FaultInjection

    engine.reset_state()
    clean = engine.run(stream)
    clean_toks = _token_map(clean)
    snapshot = {
        "paging": engine.paging_stats(),
        "cache_bytes": int(sum(_tree_nbytes(lane.cache)
                               for lane in engine.lanes
                               if lane.cache is not None)),
    }
    out = []
    for step, seed in grid:
        engine.reset_state()
        faulty = engine.run(stream, inject=[FaultInjection(
            step=step, target="kv", persistent=True, seed=seed)],
            obs=obs)
        summ = faulty.summary()
        inj = summ["faults"]["injections"]
        toks = _token_map(faulty)
        corrupted = [rid for rid in toks
                     if toks[rid] != clean_toks.get(rid)]
        out.append({
            "step": step, "seed": seed,
            "applied": len(inj) > 0,
            "detected": any(i["detected"] for i in inj),
            "corrupted": len(corrupted),
            "injections": inj,
            "summary": summ,
        })
    engine.reset_state()
    return clean, snapshot, out


# ------------------------------ cells ---------------------------------------

def run_parity_cell(plan: PagingCellPlan, spec: PagingSoakSpec, *,
                    paged_engine, contig_engine, obs=None) -> dict:
    """Paged vs contiguous under the same KV bit-flip grid."""
    t0 = time.perf_counter()
    grid = [(s, spec.seed + 17 * i)
            for i, s in enumerate(plan.inject_steps)]
    stream_p = _stream(spec, paged_engine)
    stream_c = _stream(spec, contig_engine)

    clean_p, snap_p, faults_p = _fault_passes(paged_engine, stream_p,
                                              grid, obs=obs)
    pstats = next(iter(snap_p["paging"].values()), {})
    clean_c, snap_c, faults_c = _fault_passes(contig_engine, stream_c, grid)

    def rates(clean, faults):
        applied = [f for f in faults if f["applied"]]
        det = sum(1 for f in applied if f["detected"])
        n = len(applied)
        esc = sum(1 for f in applied
                  if not f["detected"] and f["corrupted"])
        steps = len(clean.steps)
        flags = len(clean.detection_steps())
        return {"samples": n, "detected": det,
                "detection_rate": det / n if n else 0.0,
                "escapes": esc, "escape_rate": esc / n if n else 0.0,
                "false_positives": flags, "clean_samples": steps,
                "fp_rate": flags / steps if steps else 0.0}

    rp, rc = rates(clean_p, faults_p), rates(clean_c, faults_c)
    ci_p = wilson_interval(rp["detected"], rp["samples"])
    ci_c = wilson_interval(rc["detected"], rc["samples"])
    parity_ok = intervals_overlap(ci_p, ci_c)

    # verify-cost: measured paged page compares vs analytic contiguous
    # whole-prefix row compares, both per emitted decode token
    checks = clean_p.fault_counters().get("kv_cache_paged_checks", 0)
    dtoks = _decode_tokens(clean_p)
    pages_per_token = checks / dtoks if dtoks else 0.0
    contig_per_token = _contig_compares_per_token(
        clean_c, contig_engine.max_prompt)
    verify_ok = 0.0 < pages_per_token < contig_per_token

    # memory: peak resident paged pool bytes vs the fixed-slot layout
    peak_bytes = int(pstats.get("peak_resident_bytes", 0))
    fixed_bytes = snap_c["cache_bytes"]
    bytes_ok = 0 < peak_bytes < fixed_bytes

    clean_ps = clean_p.summary()
    metrics = PagingMetrics({
        **rp,
        "analytic_bound": None,
        "overhead": None,
        "contig_detection_rate": rc["detection_rate"],
        "contig_fp_rate": rc["fp_rate"],
        "contig_samples": rc["samples"],
        "detection_ci": list(ci_p),
        "contig_detection_ci": list(ci_c),
        "parity_ok": bool(parity_ok),
        "pages_verified_per_token": pages_per_token,
        "contig_rows_verified_per_token": contig_per_token,
        "verify_ok": bool(verify_ok),
        "peak_resident_kv_bytes": peak_bytes,
        "fixed_slot_kv_bytes": fixed_bytes,
        "bytes_ok": bool(bytes_ok),
        "prefix_hit_rate": pstats.get("prefix_hit_rate", 0.0),
        "shared_prefix_tokens": sum(
            t["shared_prefix_tokens"]
            for t in clean_ps["per_tenant"].values()),
        "prefill_tokens": sum(
            t["prefill_tokens"] for t in clean_ps["per_tenant"].values()),
        "completed": sum(
            t["completed"] for t in clean_ps["per_tenant"].values()),
        "throughput_tok_s": clean_ps["throughput_tok_s"],
    })
    _publish_cell(obs, plan, metrics)
    return {"plan": plan, "metrics": metrics,
            "seconds": time.perf_counter() - t0}


def run_rebuild_cell(plan: PagingCellPlan, spec: PagingSoakSpec, *,
                     rebuild_engine, obs=None) -> dict:
    """One persistent KV flip under ``policy=recompute``: the engine must
    detect it, evict the corrupt page, and re-prefill the owner online."""
    from repro_torch.serving.engine import FaultInjection

    t0 = time.perf_counter()
    grid = [(s, spec.seed + 17 * i)
            for i, s in enumerate(plan.inject_steps)]
    stream = _stream(spec, rebuild_engine)

    rebuild_engine.reset_state()
    clean = rebuild_engine.run(stream)
    clean_toks = _token_map(clean)
    clean_flags = len(clean.detection_steps())
    clean_steps = len(clean.steps)

    detected = applied = rebuilds = aborted = completed = 0
    escapes = 0
    for step, seed in grid:
        rebuild_engine.reset_state()
        faulty = rebuild_engine.run(stream, inject=[FaultInjection(
            step=step, target="kv", persistent=True, seed=seed)],
            obs=obs)
        st = next(iter(rebuild_engine.paging_stats().values()), {})
        rebuilds += int(st.get("page_rebuilds", 0))
        summ = faulty.summary()
        inj = summ["faults"]["injections"]
        applied += len(inj) > 0
        detected += any(i["detected"] for i in inj)
        toks = _token_map(faulty)
        corrupted = [rid for rid in toks
                     if toks[rid] != clean_toks.get(rid)]
        if inj and not any(i["detected"] for i in inj) and corrupted:
            escapes += 1
        aborted += sum(t["aborted"]
                       for t in summ["per_tenant"].values())
        completed += sum(t["completed"]
                         for t in summ["per_tenant"].values())
    rebuild_engine.reset_state()

    n = max(applied, 1)
    metrics = PagingMetrics({
        "samples": applied,
        "detected": detected,
        "detection_rate": detected / n,
        "escapes": escapes,
        "escape_rate": escapes / n,
        "false_positives": clean_flags,
        "clean_samples": clean_steps,
        "fp_rate": clean_flags / clean_steps if clean_steps else 0.0,
        "analytic_bound": None,
        "overhead": None,
        "page_rebuilds": rebuilds,
        "rebuild_ok": bool(rebuilds >= 1 and completed > 0),
        "aborted": aborted,
        "completed": completed,
    })
    _publish_cell(obs, plan, metrics)
    return {"plan": plan, "metrics": metrics,
            "seconds": time.perf_counter() - t0}


def _publish_cell(obs, plan: PagingCellPlan,
                  metrics: PagingMetrics) -> None:
    if obs is None:
        return
    from repro_torch.obs import FaultEvent
    reg = obs.registry
    reg.counter("repro_injections_total",
                "injected faults per campaign cell"
                ).inc(metrics["samples"], cell=plan.cell_id)
    reg.counter("repro_detections_total",
                "online-detected injected faults per campaign cell"
                ).inc(metrics["detected"], cell=plan.cell_id)
    reg.counter("repro_false_positives_total",
                "clean-pass flags per campaign cell"
                ).inc(metrics["false_positives"], cell=plan.cell_id)
    obs.bus.emit(FaultEvent(
        op=plan.target, kind="cell", step=0, source="serving.paging",
        cell_id=plan.cell_id, errors=metrics["detected"],
        checks=metrics["samples"],
        detector_value=metrics["detection_rate"],
        attrs={k: metrics[k] for k in
               ("fp_rate", "false_positives", "parity_ok", "verify_ok",
                "bytes_ok", "rebuild_ok", "page_rebuilds")
               if k in metrics.to_dict()}))


# ------------------------------ campaign ------------------------------------

def quick_paging_spec(seed: int = 0, plan: Optional[str] = None
                      ) -> PagingSoakSpec:
    # pool sizing: 4 slots * 6 pages worst case = 24 referenced pages;
    # 28 leaves warm-prefix headroom while staying strictly below the
    # fixed-slot layout's bytes, so the cell's memory bit measures real
    # LRU eviction behavior rather than an oversized pool
    return PagingSoakSpec(
        name="paging", arch=PAGING_ARCH, n_requests=24, n_slots=4,
        rate_rps=200.0, max_new_tokens=16, page_size=8, n_pages=28,
        prefix_len=16, n_faults=6, seed=seed,
        plan=plan if plan is not None else PAGED_PLAN)


def full_paging_spec(seed: int = 0, plan: Optional[str] = None
                     ) -> PagingSoakSpec:
    return PagingSoakSpec(
        name="paging", arch=PAGING_ARCH, n_requests=64, n_slots=4,
        rate_rps=200.0, max_new_tokens=16, page_size=8, n_pages=28,
        prefix_len=16, n_faults=12, seed=seed,
        plan=plan if plan is not None else PAGED_PLAN)


def paging_plans(spec: PagingSoakSpec):
    grid = _fault_grid(spec)
    steps = tuple(s for s, _ in grid)
    base = dict(arch=spec.arch, n_requests=spec.n_requests,
                n_slots=spec.n_slots, rate_rps=spec.rate_rps,
                page_size=spec.page_size, n_pages=spec.n_pages,
                prefix_len=spec.prefix_len, seed=spec.seed)
    return [
        PagingCellPlan(cell_id=f"paging/parity/{spec.arch}",
                       target="paging", kind="parity",
                       inject_steps=steps, plan=spec.plan, **base),
        PagingCellPlan(cell_id=f"paging/rebuild/{spec.arch}",
                       target="paging", kind="rebuild",
                       inject_steps=steps[:2],
                       plan=spec.rebuild_plan, **base),
    ]


def run_paging_campaign(spec: Optional[PagingSoakSpec] = None, *,
                        quick: bool = True, seed: int = 0,
                        plan: Optional[str] = None,
                        out_dir: Optional[str] = None,
                        verbose=None, device="cuda", obs=None) -> dict:
    """Run the parity + rebuild cells on ``device``; returns (and
    optionally writes) the ``BENCH_campaign_paging[_quick]`` artifact
    dict."""
    from repro_torch.campaign.artifacts import (campaign_to_dict,
                                                write_artifacts)
    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if spec is None:
        spec = (quick_paging_spec(seed, plan) if quick
                else full_paging_spec(seed, plan))
    t0 = time.perf_counter()
    paged, contig, rebuild = _engines(spec, dev)
    cells = []
    for cp in paging_plans(spec):
        if cp.kind == "parity":
            cell = run_parity_cell(cp, spec, paged_engine=paged,
                                   contig_engine=contig, obs=obs)
        else:
            cell = run_rebuild_cell(cp, spec, rebuild_engine=rebuild,
                                    obs=obs)
        cells.append(cell)
        if verbose:
            m = cell["metrics"]
            extra = (f"parity={m['parity_ok']} verify={m['verify_ok']} "
                     f"bytes={m['bytes_ok']}" if cp.kind == "parity"
                     else f"rebuilds={m['page_rebuilds']} "
                          f"ok={m['rebuild_ok']}")
            verbose(f"[{cp.cell_id}] inj={m['samples']} "
                    f"detect={m['detection_rate']:.2f} "
                    f"fp={m['fp_rate']:.4f} {extra} "
                    f"({cell['seconds']:.1f}s)")
    name = "paging_quick" if quick else "paging"
    result = campaign_to_dict(name, [spec], cells, [],
                              wall_s=time.perf_counter() - t0,
                              seed=spec.seed, device=dev)
    if out_dir is not None:
        write_artifacts(result, out_dir)
    return result


__all__ = ["PagingSoakSpec", "PagingCellPlan", "PagingMetrics",
           "wilson_interval", "intervals_overlap", "run_parity_cell",
           "run_rebuild_cell", "paging_plans", "run_paging_campaign",
           "quick_paging_spec", "full_paging_spec", "PAGING_ARCH",
           "PAGED_PLAN", "CONTIG_PLAN", "REBUILD_PLAN"]
