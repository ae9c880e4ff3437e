"""Declarative protection over the ported ABFT operators.

* :class:`ProtectionPlan` / :class:`OpRule` — ordered per-op-pattern rules
  (``"qgemm/bottom.*:policy=recompute,embedding_bag:off"``), the JAX
  package's plan language unchanged;
* :class:`~repro_torch.protect.ops.ProtectedOp` adapters — ``qgemm`` and
  ``embedding_bag`` over :mod:`repro_torch.kernels.ops`;
* :func:`protected_call` — the single runtime every layer call site goes
  through (rule resolution, scheme dispatch, log / recompute / correct /
  abort);
* :func:`protect` — wrap a model apply function so serving selects
  protection purely by plan.
"""
from repro_torch.core.policy import (FaultReport, empty_report,
                                     merge_reports, op_kinds, op_report,
                                     register_op_kind)
from repro_torch.protect.api import Protected, encode_tree, protect
from repro_torch.protect.ops import (Check, OPS, ProtectedOp, get_op,
                                     register_op)
from repro_torch.protect.plan import (OpRule, POLICY_NAMES, ProtectionPlan,
                                      ResolvedRule, default_plan,
                                      unprotected_plan)
from repro_torch.protect.runtime import protected_call, rule_for

__all__ = [
    "ProtectionPlan", "OpRule", "ResolvedRule", "POLICY_NAMES",
    "default_plan", "unprotected_plan",
    "ProtectedOp", "Check", "OPS", "register_op", "get_op",
    "protected_call", "rule_for",
    "protect", "Protected", "encode_tree",
    "FaultReport", "op_report", "empty_report", "merge_reports",
    "op_kinds", "register_op_kind",
]
