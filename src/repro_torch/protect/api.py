"""``protect(apply_fn, plan)`` — the one-call front door.

Wraps a model apply function (``fn(params, *args, ctx=..., **kw) ->
(..., FaultReport)``, e.g. a ``dlrm_forward`` partial) so that:

* the plan reaches every protected call site via the layer ``Ctx``;
* weights are encoded once via :meth:`Protected.encode` (checksum lanes
  packed, table row sums refreshed) — the amortized §IV-A1 step;
* the trailing :class:`~repro_torch.core.policy.FaultReport` is split off
  and returned as ``(output, report)``.

    plan = ProtectionPlan.parse("*:policy=log,embedding_bag:off")
    fwd = protect(functools.partial(dlrm_forward, ex=ex), plan)
    logits, report = fwd(params, dense, bags)
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from repro_torch.core import table_rowsums
from repro_torch.core.policy import FaultReport, empty_report, merge_reports
from repro_torch.protect.ops import get_op
from repro_torch.protect.plan import ProtectionPlan


def _find_reports(out: Any) -> list:
    """Every FaultReport reachable through tuples/lists/dicts in ``out``."""
    if isinstance(out, FaultReport):
        return [out]
    if isinstance(out, (tuple, list)):
        return [r for v in out for r in _find_reports(v)]
    if isinstance(out, dict):
        return [r for v in out.values() for r in _find_reports(v)]
    return []


class Protected:
    """A plan-bound apply function.  See module docstring."""

    def __init__(self, apply_fn: Callable, plan: ProtectionPlan, *,
                 ctx=None, **ctx_overrides):
        from repro_torch.layers.common import Ctx
        base = ctx if ctx is not None else Ctx(quant=True)
        self.plan = plan
        self.ctx = base.replace(plan=plan, **ctx_overrides)
        self.apply_fn = apply_fn

    def encode(self, params):
        """Refresh every amortized encoding in a param tree (packed GEMM
        checksum lanes, table row sums).  Call once after loading or
        mutating weights."""
        return encode_tree(params)

    def __call__(self, params, *args, **kwargs):
        out = self.apply_fn(params, *args, ctx=self.ctx, **kwargs)
        if isinstance(out, tuple) and out and isinstance(out[-1],
                                                         FaultReport):
            rest = out[:-1]
            return (rest[0] if len(rest) == 1 else rest), out[-1]
        reports = _find_reports(out)
        return out, (merge_reports(*reports) if reports else empty_report())


def protect(apply_fn: Callable, plan: ProtectionPlan, *, ctx=None,
            **ctx_overrides) -> Protected:
    """Bind ``apply_fn`` to a :class:`ProtectionPlan`.

    ``ctx`` seeds the layer context (default: the int8 serving
    ``Ctx(quant=True)``); keyword overrides are forwarded to
    ``ctx.replace`` (e.g. ``compute_dtype=torch.float32``).
    """
    return Protected(apply_fn, plan, ctx=ctx, **ctx_overrides)


def encode_tree(params: Any) -> Any:
    """Walk a param tree and recompute every derived encoding:

    * dicts holding ``w_packed`` get their checksum lanes re-encoded from
      the weight block (leading stack dims included), and a sibling
      ``colsum`` (the Eq. 1 requantization constant) recomputed with them;
    * dicts holding ``table`` + ``rowsums`` get row sums recomputed, one
      table at a time.

    Returns a new tree; everything else passes through untouched.
    """
    qgemm = get_op("qgemm")

    def rec(node):
        if isinstance(node, dict):
            node = {k: rec(v) for k, v in node.items()}
            if "w_packed" in node:
                packed = node["w_packed"]
                w_q = packed[..., :, :packed.shape[-1] - qgemm.lane]
                node["w_packed"] = qgemm.encode(w_q)
                if "colsum" in node:
                    # stale colsum is silent output corruption, not a
                    # detection miss: it is derived from the weights too
                    node["colsum"] = qgemm.dequant_colsum(w_q)
            if "table" in node and "rowsums" in node:
                node["rowsums"] = table_rowsums(node["table"])
            return node
        if isinstance(node, (list, tuple)):
            return type(node)(rec(v) for v in node)
        return node

    with torch.no_grad():
        return rec(params)
