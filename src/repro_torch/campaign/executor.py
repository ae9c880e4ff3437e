"""The campaign executor.

One cell = hundreds of (inject → run → count) trials.  The JAX package
vmaps a cell's trials over a key batch; here a cell loops over its trials
on one device.  Each trial's flags stay on the device, and the host reads
them once per chunk of :data:`CHUNK` trials, so the card is not stalled by
a synchronisation per trial.  Faults and bags are drawn on CPU generators
(:func:`_generators`), so one seed gives the same trials on the CPU and on
the card.

A target with a soak protocol (the decode soak) runs its faulty trials
through it: the cell then also records the per-step first-detection
latency histogram and the token divergence from the clean twin run.

On the card the protected calls run the CUDA kernels; a kernel that fails
to build or launch fails the cell (nothing falls back).

A campaign with sharded cells (``data_shards`` > 1: the training soaks)
runs in a world of ranks launched once for the whole run
(:func:`repro_torch.sharding.launch`, ``world``): every rank walks the
sharded cells first, in grid order, each on its own slice of the world
(a ``torch.distributed`` subgroup, slices assigned round-robin, as JAX
places cells on slices of its host platform), the cell's first rank
handing its result to the others; then rank 0 runs every other cell
alone and writes the artifact, its cells in grid order.  A world
smaller than a cell's shards runs it on what there is, with a warning
and ``collective_verified`` False.

With ``obs`` (a :class:`repro_torch.obs.Observability`) each cell's
build/trials/clean/overhead phases land as spans and its outcome as
counters and a ``cell`` event; a ``monitor`` bound to it drives per-cell
health states.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
import warnings
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.campaign.metrics import CellMetrics, compute_metrics
from repro_torch.campaign.spec import CampaignSpec, CellPlan, expand
from repro_torch.campaign.targets import Trial, get_target
from repro_torch.campaign.timing import median_time, phase_breakdown
from repro_torch.device import resolve_device

#: trials whose flags the host reads in one synchronisation
CHUNK = 256


@dataclasses.dataclass
class CellResult:
    plan: CellPlan
    metrics: CellMetrics
    seconds: float
    #: per faulty trial: (detected, corrupted), and per clean trial the
    #: flag (host bool tensors, in trial order)
    trials: torch.Tensor
    clean: torch.Tensor


def resolve_device_count(requested: Optional[int] = None,
                         device="cpu") -> int:
    """The ranks a run gets for ``--device-count``.  On the CPU ranks are
    processes, so any count is there; on the card one rank a device, and
    ranks past the cards share them (through ``gloo``).  Default: 1 on
    the CPU, the cards on the card."""
    if requested is not None and requested < 1:
        raise ValueError(f"--device-count {requested}: at least 1 rank")
    if requested:
        return requested
    if torch.device(device).type == "cuda":
        return max(torch.cuda.device_count(), 1)
    return 1


def _cell_mesh(plan: CellPlan, world, slot: int = 0):
    """-> (mesh | None, effective shards) for one cell: a sharded cell
    gets ranks ``[start, start + shards)`` of the world, ``start`` by
    ``slot`` (its index among sharded cells) round-robin over the
    world's disjoint slices.  A world smaller than ``data_shards`` runs
    the cell on what it has, with a warning (``collective_verified``
    records it).  Every rank of the world calls this."""
    if plan.data_shards <= 1:
        return None, 1
    have = world.size if world is not None else 1
    shards = min(plan.data_shards, have)
    if shards < plan.data_shards:
        warnings.warn(
            f"cell {plan.cell_id}: data_shards={plan.data_shards} > "
            f"{shards} rank(s) in the world; running at {shards} "
            f"shard(s) (collective_verified records the degradation)",
            UserWarning, stacklevel=2)
    if shards == 1:
        return None, 1
    from repro_torch.sharding import make_data_mesh
    start = (slot % (have // shards)) * shards
    return make_data_mesh(shards, range(start, start + shards)), shards


def _generators(seed: int) -> Tuple[torch.Generator, ...]:
    """CPU generators for a cell's build, faulty trials and clean trials."""
    states = np.random.SeedSequence(seed).generate_state(3)
    return tuple(torch.Generator().manual_seed(int(s)) for s in states)


def _run_trials(trial: Callable[[Trial], tuple], trials: Sequence[Trial],
                device: torch.device, chunk: int = CHUNK) -> torch.Tensor:
    """``trial(t) -> (detected, corrupted)`` over ``trials``; returns the
    host bool tensor ``[len(trials), 2]``.  Flags that are Python bools
    (a bit flip always changes its element) never leave the host."""
    true = torch.ones((), dtype=torch.bool, device=device)
    false = torch.zeros((), dtype=torch.bool, device=device)
    out = []
    for i in range(0, len(trials), chunk):
        flags = []
        for t in trials[i:i + chunk]:
            flags.extend(f if torch.is_tensor(f) else (true if f else false)
                         for f in trial(t))
        out.append(torch.stack(flags).reshape(-1, 2).cpu())
    return torch.cat(out) if out else torch.zeros((0, 2), dtype=torch.bool)


def _run_soaks(soak: Callable[[Trial], dict], trials: Sequence[Trial],
               chunk: int = CHUNK) -> dict:
    """``soak(t)`` over ``trials``, read on the host once per chunk:
    ``detected_steps`` bool ``[n, steps]``, ``corrupted`` bool ``[n]``
    and ``divergence`` float ``[n]``, and ``loss_divergence`` float
    ``[n]`` where the target reports it (the training seams)."""
    out = {"detected_steps": [], "corrupted": [], "divergence": [],
           "loss_divergence": [], "shard_detected": []}
    for i in range(0, len(trials), chunk):
        runs = [soak(t) for t in trials[i:i + chunk]]
        for k in out:
            if all(k in r for r in runs):
                out[k].append(torch.stack([r[k] for r in runs]).cpu())
    return {k: torch.cat(v) for k, v in out.items() if v}


def _soak_counts(soaks: dict, steps: int, shards: int = 1,
                 planned: int = 1):
    """(per-trial [detected, corrupted] flags, the soak columns): the
    first-detection latency histogram over detected trials, the
    divergence mean and max, and on a mesh of ``shards`` ranks (of
    ``planned``) each rank's receive-side detections."""
    det_steps = soaks["detected_steps"]
    detected = det_steps.any(dim=1)
    first = det_steps.to(torch.int32).argmax(dim=1)
    hist = [int(((first == t) & detected).sum()) for t in range(steps)]
    div = soaks["divergence"]
    n = max(len(div), 1)
    loss_div = soaks.get("loss_divergence")
    extras = {"steps": steps, "detection_latency_hist": hist,
              "divergence_mean": float(div.sum()) / n,
              "divergence_max": float(div.max()) if len(div) else 0.0,
              "loss_divergence_mean": (float(loss_div.sum()) / n
                                       if loss_div is not None else 0.0),
              "shards": shards,
              # only the planned collective counts as verified: a cell
              # run on fewer ranks says so in ``shards``
              "collective_verified": 1 < shards == planned,
              "shard_detections": None}
    if "shard_detected" in soaks:
        per_shard = soaks["shard_detected"].to(torch.int64).sum(0)
        extras["shard_detections"] = [int(c) for c in per_shard]
    return torch.stack([detected, soaks["corrupted"]], dim=1), extras


def _cell_span(obs, name: str, plan: CellPlan):
    """A tracer span for one cell phase, or a no-op without obs."""
    if obs is None:
        return contextlib.nullcontext()
    return obs.tracer.span(name, cat="campaign", cell=plan.cell_id)


def _publish_cell(obs, plan: CellPlan, metrics: CellMetrics) -> None:
    """Land one finished cell in the obs layer: outcome counters labeled
    by cell id (the Prometheus face of the artifact's CellMetrics) and a
    summary ``cell`` event carrying detector value vs analytic bound."""
    if obs is None:
        return
    from repro_torch.obs import FaultEvent
    reg = obs.registry
    labels = {"cell": plan.cell_id}
    reg.counter("repro_injections_total",
                "injected faults per cell").inc(metrics.samples, **labels)
    reg.counter("repro_detections_total",
                "detected (or masked) faults per cell").inc(
                    metrics.effective_detected, **labels)
    reg.counter("repro_escapes_total",
                "undetected corruptions (SDC) per cell").inc(
                    metrics.escapes, **labels)
    reg.counter("repro_false_positives_total",
                "clean-run flags per cell").inc(
                    metrics.false_positives, **labels)
    obs.bus.emit(FaultEvent(
        op=plan.target, step=0, source="campaign.executor", kind="cell",
        t_s=obs.tracer.now_s(), errors=metrics.detected,
        checks=metrics.samples, cell_id=plan.cell_id,
        bit_band=plan.bit_band,
        detector_value=metrics.detection_rate,
        bound=metrics.analytic_bound,
        attrs={"escapes": metrics.escapes,
               "false_positives": metrics.false_positives,
               "fp_rate": metrics.fp_rate,
               # what the {cell} detections counter was inc'd with —
               # replay reads it so round-trip stays counter-exact
               # (detected alone misses masked-by-recompute trials)
               "effective_detected": metrics.effective_detected,
               "clean_samples": metrics.clean_samples}))
    if metrics.false_positives:
        obs.bus.emit(FaultEvent(
            op=plan.target, step=0, source="campaign.executor",
            kind="false_positive", t_s=obs.tracer.now_s(),
            errors=metrics.false_positives,
            checks=metrics.clean_samples, cell_id=plan.cell_id,
            bit_band=plan.bit_band))


def run_cell(plan: CellPlan, *, device="cuda", plain: bool = False,
             chunk: int = CHUNK, obs=None, monitor=None,
             mesh=None) -> CellResult:
    """Run one cell on ``device``.  The protected calls run the kernels
    where the operands are CUDA tensors (the port's rule), unless
    ``plain`` asks for the plain versions on any device.  ``mesh`` (a
    data mesh this rank is in) runs a shardable target's soak over it;
    every rank of the mesh calls this."""
    if monitor is not None and obs is not None:
        monitor.bind(obs)          # cell events tick the health machine
    dev = resolve_device(device)
    target = get_target(plan.target)
    t0 = time.perf_counter()
    g_build, g_trial, g_clean = _generators(plan.seed)
    extra = {"mesh": mesh} if mesh is not None else {}
    with _cell_span(obs, "build", plan):
        state = target.build(plan, g_build, device=dev, plain=plain,
                             **extra)

    def trial(t):
        return target.trial(state, plan, t)

    faulty = target.draw(state, plan, g_trial, plan.samples, True)
    soak_extras: dict = {}
    with _cell_span(obs, "trials", plan):
        if target.soak is not None:
            flags, soak_extras = _soak_counts(_run_soaks(
                lambda t: target.soak(state, plan, t), faulty, chunk),
                plan.steps, mesh.size if mesh is not None else 1,
                plan.data_shards)
        else:
            flags = _run_trials(trial, faulty, dev, chunk)
    detected, corrupted = (int(c) for c in flags.sum(0))
    det_and_cor = int((flags[:, 0] & flags[:, 1]).sum())

    clean = torch.zeros((0,), dtype=torch.bool)
    if plan.clean_samples > 0:
        with _cell_span(obs, "clean", plan):
            clean = _run_trials(trial, target.draw(
                state, plan, g_clean, plan.clean_samples, False),
                dev, chunk)[:, 0]

    protected_s = unprotected_s = None
    overhead_breakdown = None
    pair = (target.overhead(state, plan)
            if plan.measure_overhead and target.overhead is not None
            else None)
    if pair is not None:
        with _cell_span(obs, "overhead", plan):
            protected_s = median_time(pair[0], device=dev)
            unprotected_s = median_time(pair[1], device=dev)
    if plan.measure_overhead and target.overhead_phases is not None:
        overhead_breakdown = phase_breakdown(
            target.overhead_phases(state, plan), device=dev,
            tracer=obs.tracer if obs is not None else None,
            cell=plan.cell_id)

    metrics = compute_metrics(
        samples=plan.samples, detected=detected, corrupted=corrupted,
        detected_and_corrupted=det_and_cor,
        clean_samples=plan.clean_samples,
        false_positives=int(clean.sum()),
        analytic_bound=target.analytic_bound(plan),
        protected_s=protected_s, unprotected_s=unprotected_s,
        overhead_breakdown=overhead_breakdown, **soak_extras)
    _publish_cell(obs, plan, metrics)
    return CellResult(plan=plan, metrics=metrics,
                      seconds=time.perf_counter() - t0, trials=flags,
                      clean=clean)


def _share(result, src: int):
    """``result`` of world rank ``src``, on every rank of the world."""
    import torch.distributed as dist
    box = [result]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def run_specs(specs: Sequence[CampaignSpec], *, device="cuda",
              chunk: int = CHUNK,
              verbose: Optional[Callable[[str], None]] = None,
              obs=None, monitor=None, world=None
              ) -> Tuple[List[CellResult], List[dict]]:
    """Expand and execute a list of specs; returns (results in grid
    order, skipped).  In a ``world`` (every rank calls this) the sharded
    cells run first, each where :func:`_cell_mesh` places it, and every
    rank gets their results; then rank 0 runs the other cells alone
    while the other ranks are done, so no rank waits in a collective
    for a cell it takes no part in.  Rank 0 returns every result, the
    other ranks the sharded cells'."""
    plans: List[CellPlan] = []
    skipped: List[dict] = []
    for spec in specs:
        got, skips = expand(spec)
        plans.extend(got)
        skipped.extend(skips)
    rank = world.rank if world is not None else 0
    results: List[Optional[CellResult]] = [None] * len(plans)

    def done(i, r):
        results[i] = r
        if verbose and rank == 0:
            m = r.metrics
            verbose(f"[{r.plan.cell_id}] n={m.samples} "
                    f"detect={m.detection_rate:.4f} "
                    f"escape={m.escape_rate:.4f} fp={m.fp_rate:.4f} "
                    f"({r.seconds:.1f}s)")

    sharded = [i for i, p in enumerate(plans)
               if get_target(p.target).shardable and p.data_shards > 1]
    for slot, i in enumerate(sharded):
        mesh, _ = _cell_mesh(plans[i], world, slot)
        src = mesh.ranks[0] if mesh is not None else 0
        r = None
        if mesh.member if mesh is not None else rank == 0:
            r = run_cell(plans[i], device=device, chunk=chunk, obs=obs,
                         monitor=monitor, mesh=mesh)
        if world is not None and world.size > 1:
            r = _share(r, src)
        done(i, r)
    if rank == 0:
        for i, plan in enumerate(plans):
            if results[i] is None:
                done(i, run_cell(plan, device=device, chunk=chunk, obs=obs,
                                 monitor=monitor))
    return [r for r in results if r is not None], skipped


def run_campaign(name: str, specs: Sequence[CampaignSpec], *,
                 device="cuda", out_dir: Optional[str] = None,
                 chunk: int = CHUNK,
                 verbose: Optional[Callable[[str], None]] = None,
                 obs=None, monitor=None, world=None) -> dict:
    """Execute specs, assemble the artifact dict, optionally write it
    (in a ``world``, rank 0 assembles and writes it; the other ranks
    return None).  ``obs`` records per-phase
    spans, cell summary events and outcome counters alongside the
    artifact; ``monitor`` additionally watches the published cell
    outcomes and drives per-cell health states."""
    from repro_torch.campaign.artifacts import (campaign_to_dict,
                                                write_artifacts)

    dev = resolve_device(device)
    t0 = time.perf_counter()
    results, skipped = run_specs(specs, device=dev, chunk=chunk,
                                 verbose=verbose, obs=obs, monitor=monitor,
                                 world=world)
    if world is not None and world.rank != 0:
        return None
    result = campaign_to_dict(
        name, list(specs),
        [{"plan": r.plan, "metrics": r.metrics, "seconds": r.seconds}
         for r in results],
        skipped, wall_s=time.perf_counter() - t0,
        seed=specs[0].seed if specs else 0, device=dev,
        ranks=world.size if world is not None else 1)
    if out_dir is not None:
        write_artifacts(result, out_dir)
    return result


__all__ = ["CHUNK", "CellResult", "resolve_device_count", "run_cell",
           "run_specs", "run_campaign"]
