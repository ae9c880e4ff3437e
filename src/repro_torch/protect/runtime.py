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
EmbeddingBag tables) counts one check per entry, and the recompute policy
retries only the entries that still report errors — the sums a JAX
``vmap`` over per-table calls gives.
"""
from __future__ import annotations

from typing import Optional

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
        return out, op_report(op, residual, corrections=applied)

    if policy_name == "recompute":
        def run():
            o, c = adapter(encoded, *inputs, rule=rule, **call_kwargs)
            return o, c.err_count

        out, err, retries = with_recompute(
            run, max_retries=rule.max_retries)()
        return out, op_report(op, err.sum(), checks=err.numel(),
                              retries=retries.sum())

    out, check = adapter(encoded, *inputs, rule=rule, **call_kwargs)
    if policy_name == "abort":
        abort_if_errors(check.err_count)
    return out, op_report(op, check.err_count.sum(),
                          checks=check.err_count.numel())
