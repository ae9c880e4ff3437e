"""The protected serving engine of the port: DLRM lookups over plan lanes.

:class:`ServingEngine` serves one-shot DLRM requests.  Tenants (traffic
classes) carry their own :class:`~repro_torch.protect.ProtectionPlan`,
and tenants sharing a plan share a **lane**: one plan-bound forward and
one admission batcher.  Per engine iteration, arrivals whose (virtual)
time has come enter the admission queue; each lane admits requests FIFO
and runs one protected forward per request; the forward's fault counters
and its wall time land in the telemetry timeline.

The clock is hybrid: arrivals are simulated offsets, service time is the
measured wall time of each forward, ended by ``torch.cuda.synchronize``
on the card, so SLO percentiles reflect real compute under the chosen
plans.  The first forward of each lane runs in :meth:`warmup`, outside
the clock.

The JAX engine's LM families, paged KV cache, fault injection,
observability, health monitor and adaptive thresholds wait for later
slices (ROADMAP A2, A8, A9); asking for one raises.
"""
from __future__ import annotations

import dataclasses
import functools
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.serving.batcher import ContinuousBatcher, Slot
from repro_torch.serving.queue import AdmissionQueue
from repro_torch.serving.telemetry import RequestRecord, StepEvent, Telemetry
from repro_torch.serving.workload import Request


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One traffic class: its protection plan and relative traffic share."""
    name: str
    plan: object = None            # ProtectionPlan (None = default_plan())
    weight: float = 1.0

    def resolved_plan(self):
        from repro_torch.protect import default_plan
        return self.plan if self.plan is not None else default_plan()


def tenant_weights(tenants: Sequence[TenantSpec]) -> Dict[str, float]:
    return {t.name: t.weight for t in tenants}


def _counters_of(metrics: dict) -> tuple:
    """(per-op int counters, total residual errors) from step metrics."""
    from repro_torch.core.policy import op_kinds
    out: Dict[str, int] = {}
    errors = 0
    for k in op_kinds():
        c = int(metrics.get(f"abft/{k}_checks", 0))
        e = int(metrics.get(f"abft/{k}_errors", 0))
        out[f"{k}_checks"] = c
        out[f"{k}_errors"] = e
        errors += e
    out["retries"] = int(metrics.get("abft/retries", 0))
    out["corrections"] = int(metrics.get("abft/corrections", 0))
    return out, errors


class _Lane:
    """One protection plan's slice of the engine: the plan-bound forward
    and the admission batcher."""

    def __init__(self, key: str, plan, tenants: List[str], n_slots: int):
        self.key = key
        self.plan = plan
        self.tenants = set(tenants)
        self.batcher = ContinuousBatcher(n_slots)
        self.forward_fn = None

    def accepts(self, req: Request) -> bool:
        return req.tenant in self.tenants


class ServingEngine:
    def __init__(self, cfg, tenants: Sequence[TenantSpec], *,
                 n_slots: int = 4, queue_depth: int = 0, seed: int = 0,
                 compute_dtype=None, dlrm_extras=None, device="cuda"):
        from repro_torch.device import resolve_device
        from repro_torch.models.dlrm import init_dlrm

        if cfg.family != "dlrm":
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP A8); "
                "the port serves dlrm")
        if not tenants:
            raise ValueError("need at least one TenantSpec")
        names = [t.name for t in tenants]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names in {names}")

        self.device = resolve_device(device)
        if self.device.type == "cuda":
            # the interaction's Gram product must stay full float32
            torch.backends.cuda.matmul.allow_tf32 = False
        self.cfg = cfg
        self.tenants = {t.name: t for t in tenants}
        self.n_slots = n_slots
        self.queue = AdmissionQueue(max_depth=queue_depth)
        self.clock_s = 0.0
        self.global_step = 0
        self._compute_dtype = (torch.bfloat16 if compute_dtype is None
                               else compute_dtype)
        self._warm = False

        from repro_torch.configs.dlrm import EXTRAS
        self.dlrm_extras = dlrm_extras if dlrm_extras is not None \
            else EXTRAS
        self.params = init_dlrm(seed, self.dlrm_extras, device=self.device)

        # ------------------------- plan lanes --------------------------------
        by_plan: Dict[str, List[TenantSpec]] = {}
        for t in tenants:
            by_plan.setdefault(t.resolved_plan().describe(), []).append(t)
        self.lanes: List[_Lane] = []
        for i, (pkey, specs) in enumerate(sorted(by_plan.items())):
            plan = specs[0].resolved_plan()
            lane = _Lane(key=f"lane{i}[{plan.name or pkey}]", plan=plan,
                         tenants=[t.name for t in specs], n_slots=n_slots)
            self._build_lane_fns(lane)
            self.lanes.append(lane)
        self._lane_of = {name: lane for lane in self.lanes
                         for name in lane.tenants}

    # ------------------------------ lane steps -------------------------------

    def _build_lane_fns(self, lane: _Lane) -> None:
        from repro_torch.core.policy import metrics_to_ints
        from repro_torch.models.dlrm import dlrm_forward
        from repro_torch.protect import protect

        fwd_p = protect(functools.partial(dlrm_forward, ex=self.dlrm_extras),
                        lane.plan, compute_dtype=self._compute_dtype)

        def forward(params, dense, bags):
            logit, rep = fwd_p(params, dense, bags)
            # one device->host copy of every counter per request
            return logit, metrics_to_ints(rep.as_metrics())

        lane.forward_fn = forward

    def _payload(self, req: Request):
        """The request's tensors on the device, validated on the host
        first: indices come from outside and feed a gather."""
        dense = np.asarray(req.payload["dense"], np.float32)
        bags = np.asarray(req.payload["bags"])
        ex = self.dlrm_extras
        if dense.ndim != 2 or dense.shape[1] != ex.n_dense:
            raise ValueError(f"request {req.rid}: dense must be "
                             f"[B, {ex.n_dense}], got {dense.shape}")
        if bags.ndim != 3 or bags.shape[:2] != (ex.n_tables,
                                                dense.shape[0]):
            raise ValueError(f"request {req.rid}: bags must be "
                             f"[{ex.n_tables}, B, pool], got {bags.shape}")
        if bags.size and (bags.max() >= ex.table_rows or bags.min() < -1):
            raise ValueError(f"request {req.rid}: bag index outside "
                             f"[-1, {ex.table_rows})")
        return (torch.from_numpy(dense).to(self.device),
                torch.from_numpy(bags.astype(np.int32)).to(self.device))

    # ------------------------------ warmup -----------------------------------

    def warmup(self, sample: Optional[Request] = None) -> None:
        """Run every lane's forward once outside the telemetry clock (the
        first call builds and loads the CUDA kernels)."""
        if self._warm:
            return
        ex = self.dlrm_extras
        if sample is not None and sample.payload is not None:
            dense, bags = self._payload(sample)
        else:
            dense = torch.zeros((1, ex.n_dense), device=self.device)
            bags = torch.zeros((ex.n_tables, 1, 1), dtype=torch.int32,
                               device=self.device)
        for lane in self.lanes:
            lane.forward_fn(self.params, torch.zeros_like(dense),
                            torch.zeros_like(bags))
        self._sync()
        self._warm = True

    # ------------------------------ engine steps -----------------------------

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _timed(self, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        self._sync()
        dt = time.perf_counter() - t0
        self.clock_s += dt
        return out, dt

    def _record_slot(self, slot: Slot, telemetry: Telemetry,
                     aborted: bool = False):
        req = slot.request
        telemetry.add_request(RequestRecord(
            rid=req.rid, tenant=req.tenant, kind=req.kind,
            arrival_s=req.arrival_s, admit_s=slot.admit_s,
            first_token_s=slot.first_token_s, finish_s=self.clock_s,
            prompt_len=req.prompt_len, tokens_out=slot.generated,
            queue_wait_s=slot.queue_wait_s, aborted=aborted))

    def _step_event(self, lane: _Lane, dt: float, metrics,
                    telemetry: Telemetry,
                    errors_override: Optional[int] = None,
                    slot_rids: tuple = ()):
        counters, errors = (_counters_of(metrics) if metrics is not None
                            else ({}, 0))
        if errors_override is not None:
            errors = errors_override
        telemetry.add_step(StepEvent(
            step=self.global_step, t_s=self.clock_s, kind="dlrm",
            lane=lane.key, duration_s=dt,
            occupancy=lane.batcher.occupancy(),
            queue_depth=self.queue.depth(), counters=counters,
            errors=errors, slot_rids=tuple(slot_rids)))
        return errors

    def _do_dlrm(self, lane: _Lane, slot_like: Slot, telemetry: Telemetry):
        from repro_torch.core.policy import is_fault_abort

        req = slot_like.request
        dense, bags = self._payload(req)
        aborted = False
        metrics, dt = None, 0.0
        t0 = time.perf_counter()
        try:
            (_, metrics), dt = self._timed(lane.forward_fn, self.params,
                                           dense, bags)
        except Exception as e:          # noqa: BLE001 - abort policy only
            if not is_fault_abort(e):
                raise
            self._sync()
            dt = time.perf_counter() - t0
            self.clock_s += dt
            aborted = True
        slot_like.first_token_s = None if aborted else self.clock_s
        self._record_slot(slot_like, telemetry, aborted=aborted)
        self._step_event(lane, dt, metrics, telemetry,
                         errors_override=1 if aborted else None,
                         slot_rids=(req.rid,))

    # ------------------------------ main loop --------------------------------

    def run(self, requests: Sequence[Request], *,
            telemetry: Optional[Telemetry] = None, warmup: bool = True,
            max_iterations: int = 1_000_000) -> Telemetry:
        """Serve ``requests`` to completion and return the timeline."""
        telemetry = telemetry if telemetry is not None else Telemetry()
        pending = sorted(requests, key=lambda r: (r.arrival_s, r.rid))
        for r in pending:
            if r.tenant not in self._lane_of:
                raise ValueError(f"request {r.rid} names unknown tenant "
                                 f"{r.tenant!r}; have "
                                 f"{sorted(self._lane_of)}")
            if r.kind != "dlrm":
                raise NotImplementedError(
                    f"request {r.rid}: {r.kind!r} requests are not ported "
                    "yet (ROADMAP A8)")
        if warmup:
            self.warmup(pending[0] if pending else None)
        return self._run_loop(pending, telemetry, max_iterations)

    def _run_loop(self, pending, telemetry, max_iterations) -> Telemetry:
        i = 0
        it = 0
        while True:
            it += 1
            if it > max_iterations:
                raise RuntimeError("engine exceeded max_iterations "
                                   "(stuck request stream?)")
            # 1. arrivals whose time has come; a full bounded queue sheds
            #    load — the rejection IS the SLO story, so it is recorded
            while i < len(pending) and pending[i].arrival_s <= self.clock_s:
                req = pending[i]
                if not self.queue.push(req, self.clock_s):
                    telemetry.add_request(RequestRecord(
                        rid=req.rid, tenant=req.tenant, kind=req.kind,
                        arrival_s=req.arrival_s, admit_s=self.clock_s,
                        first_token_s=None, finish_s=self.clock_s,
                        prompt_len=req.prompt_len, tokens_out=0,
                        queue_wait_s=0.0, aborted=True, rejected=True))
                i += 1
            if not self.queue:
                if i >= len(pending):
                    break
                # idle: jump the virtual clock to the next arrival
                self.clock_s = max(self.clock_s, pending[i].arrival_s)
                continue

            # 2. admissions, each a one-shot protected forward
            for lane in self.lanes:
                for slot in lane.batcher.admit(self.queue, self.clock_s,
                                               accept=lane.accepts):
                    lane.batcher.retire(slot.index)
                    self._do_dlrm(lane, slot, telemetry)
            self.global_step += 1

        telemetry.finalize_injections()
        return telemetry


__all__ = ["ServingEngine", "TenantSpec", "tenant_weights"]
