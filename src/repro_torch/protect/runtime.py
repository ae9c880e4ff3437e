"""Protected-call runtime: resolve a plan rule, run the adapter, apply the
detect->act policy, emit the op-keyed report.

This is the single code path every protected call site goes through:

    c, rep = protected_call("qgemm", packed, x_q, ctx=ctx, name="bottom.0")

``ctx`` is duck-typed: anything with an optional ``plan``
(:class:`~repro_torch.protect.plan.ProtectionPlan`) attribute plus the
legacy ``abft`` / ``float_abft`` booleans.  With no plan, the legacy flags
give the JAX package's behavior (qgemm/EB gated by ``abft``, float GEMMs
by ``float_abft``, KV cache off).

A call whose adapter reports one count per independent check (a stack of
EmbeddingBag tables, a stack of MoE experts) counts one check per entry,
and the recompute policy keeps the re-run only for the entries that still
report errors — the sums a JAX ``vmap`` over per-table or per-expert
calls gives.

:func:`observe_metrics` lands one step's counters, already copied to the
host, in an :class:`~repro_torch.obs.Observability` bundle.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.policy import (abort_if_errors, empty_report,
                                     op_report, with_recompute)
from repro_torch.protect.ops import get_op
from repro_torch.protect.plan import ProtectionPlan, ResolvedRule


def rule_for(ctx, op: str, name: str = "") -> ResolvedRule:
    """The plan rule governing op kind ``op`` at call site ``name``."""
    plan: Optional[ProtectionPlan] = getattr(ctx, "plan", None)
    if plan is not None:
        return plan.resolve(op, name)
    if ctx is None:
        return ResolvedRule()
    # legacy Ctx flags (pre-plan behavior)
    if op == "float_gemm":
        return ResolvedRule(enabled=bool(getattr(ctx, "float_abft", False)))
    if op in ("kv_cache", "kv_cache_paged"):
        return ResolvedRule(enabled=False)
    return ResolvedRule(enabled=bool(getattr(ctx, "abft", True)))


def _total(counts):
    """An int32 count (or vector of counts) summed in int32, as ``jnp.sum``
    keeps it: one reduction, where torch's default int64 sum would first
    cast the counts on the card (a second kernel)."""
    return counts.sum(dtype=torch.int32)


def protected_call(op: str, encoded, *inputs, ctx=None,
                   rule: Optional[ResolvedRule] = None, name: str = "",
                   **call_kwargs):
    """Run one protected op under its resolved plan rule.

    Returns ``(out, FaultReport)``.  Policy semantics:

    * ``log``       — verify, count, pass through;
    * ``recompute`` — re-run up to ``rule.max_retries`` times while errors
                      persist (retries counted);
    * ``correct``   — adapters with ``supports_correct`` repair the single
                      flagged cell via row+column checksums; others fall
                      back to ``recompute`` (repair-or-retry);
    * ``abort``     — raise :class:`repro_torch.core.policy.FaultAbort`.

    A disabled rule runs the adapter's unprotected baseline and reports
    zero checks.
    """
    adapter = get_op(op)
    if rule is None:
        rule = rule_for(ctx, op, name)
    if not rule.enabled:
        return adapter.unprotected(encoded, *inputs,
                                   **call_kwargs), empty_report()

    policy_name = rule.policy
    if policy_name == "correct" and not adapter.supports_correct:
        policy_name = "recompute"

    if policy_name == "correct":
        out, check = adapter(encoded, *inputs, rule=rule, **call_kwargs)
        out, residual, applied = adapter.correct(out, check)
        if residual.dim():                  # one check per expert
            return out, op_report(op, _total(residual),
                                  checks=residual.numel(),
                                  corrections=_total(applied))
        return out, op_report(op, residual, corrections=applied)

    if policy_name == "recompute":
        def run():
            o, c = adapter(encoded, *inputs, rule=rule, **call_kwargs)
            return o, c.err_count

        out, err, retries = with_recompute(
            run, max_retries=rule.max_retries)()
        return out, op_report(op, _total(err), checks=err.numel(),
                              retries=_total(retries))

    out, check = adapter(encoded, *inputs, rule=rule, **call_kwargs)
    if policy_name == "abort":
        abort_if_errors(check.err_count)
    # an adapter whose one call covers a variable amount of verified state
    # (the pages a paged KV read touches) reports it in Check.aux, so the
    # checks counter prices verification work, not calls
    n_checks = check.err_count.numel()
    if isinstance(check.aux, dict) and "n_checks" in check.aux:
        n_checks = check.aux["n_checks"]
    return out, op_report(op, _total(check.err_count), checks=n_checks)


def observe_metrics(metrics, *, source: str, step: int = 0,
                    t_s: float = 0.0, obs=None, cell_id=None,
                    request_ids=(), bit_band=None, shard=None,
                    attrs=None) -> int:
    """Land one step's FaultReport counters host-side.

    ``metrics`` is the step's counter dict as the step already copied it
    to the host (``metrics_to_ints``: Python ints), so this reads no
    tensor.  Increments the ``repro_abft_{checks,errors}_total`` counters
    (plus one ``repro_detections_total{op,source}`` inc per flagged op),
    emits one ``detection`` :class:`~repro_torch.obs.FaultEvent` per
    flagged op kind, and — when anything was checked or the caller passed
    step ``attrs`` (the serving engine's lane/tenant/duration context) —
    one ``info``/``channel=step`` summary event carrying the per-op
    (checks, errors) counts.  That summary is what feeds the live
    :class:`~repro_torch.obs.Monitor` and makes
    ``repro_torch.obs.replay`` exact.  Returns the step's total residual
    errors; a ``None`` obs is a cheap no-op path that still returns the
    error count.
    """
    from repro_torch.obs.events import op_counts

    counts = op_counts(metrics)
    errors = sum(errs for _, _, errs in counts)
    if obs is None:
        return errors
    from repro_torch.obs import FaultEvent, events_from_metrics
    by_op = {}
    total_checks = 0
    for kind, checks, errs in counts:
        if checks or errs:
            by_op[kind] = [int(checks), int(errs)]
            total_checks += int(checks)
            obs.registry.counter(
                "repro_abft_checks_total",
                "ABFT checks by op kind").inc(checks, op=kind,
                                              source=source)
            obs.registry.counter(
                "repro_abft_errors_total",
                "residual ABFT errors by op kind").inc(errs, op=kind,
                                                       source=source)
        if errs > 0:
            labels = {"op": kind, "source": source}
            if cell_id:
                labels["cell"] = cell_id
            obs.registry.counter(
                "repro_detections_total",
                "detected faults by op kind, source, and cell"
            ).inc(1, **labels)
    obs.bus.extend(events_from_metrics(
        metrics, step=step, source=source, t_s=t_s, cell_id=cell_id,
        request_ids=tuple(request_ids), bit_band=bit_band, shard=shard))
    if by_op or attrs:
        obs.bus.emit(FaultEvent(
            op="step", step=step, source=source, kind="info", t_s=t_s,
            errors=int(errors), checks=total_checks, cell_id=cell_id,
            attrs={"channel": "step", "by_op": by_op, **(attrs or {})}))
    return errors


def kv_rule(ctx, name: str = "attn") -> ResolvedRule:
    """The kv_cache rule for attention layers, additionally gated on the
    int8 serving path (``ctx.quant``): a bf16 training cache has nothing
    to checksum."""
    r = rule_for(ctx, "kv_cache", name)
    if r.enabled and not bool(getattr(ctx, "quant", False)):
        return dataclasses.replace(r, enabled=False)
    return r


def paged_kv_rule(ctx, name: str = "attn") -> ResolvedRule:
    """The kv_cache_paged rule with its policy forced to ``log``.

    Page repair under recompute/abort is a host-side allocator action
    (evict the flagged page, rebuild prompt pages via re-prefill, or
    abort the owning request) — the serving engine applies it between
    steps.  The protected read itself only counts; the plan's policy
    still decides what the engine does with the flag."""
    return dataclasses.replace(rule_for(ctx, "kv_cache_paged", name),
                               policy="log")
