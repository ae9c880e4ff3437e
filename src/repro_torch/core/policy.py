"""Fault reports and detect->act policies.

Every ABFT-protected op contributes to a :class:`FaultReport`, keyed by op
kind with the JAX package's key set (``qgemm``, ``float_gemm``,
``embedding_bag``, ``kv_cache``, ``kv_cache_paged``) and the same
``as_metrics()`` names, legacy aliases included — even for kinds whose
adapters are not ported yet, so metrics from the two packages compare key
for key.  Counters are Python ints or 0-d tensors on the op's device; a
caller turns them into ints once per step, which is the only host sync a
``log``-policy forward needs.

Policies decide what a call does when errors are reported:

- ``log``       — surface counts in the metrics (no control flow)
- ``recompute`` — re-run the op while errors persist, up to ``max_retries``
                  times (a Python ``if``; retries are counted)
- ``correct``   — repair the single flagged cell via the row + column
                  checksums; multi-error results keep their count
- ``abort``     — raise :class:`FaultAbort` (serving: fail the request,
                  not the server)
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Union

import torch

Count = Union[int, torch.Tensor]

#: built-in op kinds — the JAX package's report key set, in its order.
_DEFAULT_OP_KINDS = ("qgemm", "float_gemm", "embedding_bag", "kv_cache",
                     "kv_cache_paged")
_OP_KINDS = list(_DEFAULT_OP_KINDS)


def op_kinds() -> tuple:
    """Currently registered op kinds (report key set)."""
    return tuple(_OP_KINDS)


def register_op_kind(name: str) -> None:
    """Add an op kind to the report key set."""
    if name not in _OP_KINDS:
        _OP_KINDS.append(name)


@dataclasses.dataclass
class FaultReport:
    """Per-op-kind ABFT counters.

    ``checks[name]`` / ``errors[name]`` count verified calls and residual
    (post-policy) errors per op kind; ``retries`` and ``corrections``
    aggregate the recompute/correct policy actions across all kinds.
    """
    checks: Dict[str, Count]
    errors: Dict[str, Count]
    retries: Count = 0
    corrections: Count = 0

    def total_errors(self) -> Count:
        return sum(self.errors.values(), 0)

    def total_checks(self) -> Count:
        return sum(self.checks.values(), 0)

    def as_metrics(self) -> dict:
        m = {}
        for n in sorted(self.checks):
            m[f"abft/{n}_checks"] = self.checks[n]
            m[f"abft/{n}_errors"] = self.errors[n]
        m["abft/retries"] = self.retries
        m["abft/corrections"] = self.corrections
        # legacy aliases (pre-protect metric names; gemm = int8 + float)
        m["abft/gemm_checks"] = self.gemm_checks
        m["abft/gemm_errors"] = self.gemm_errors
        m["abft/eb_checks"] = self.eb_checks
        m["abft/eb_errors"] = self.eb_errors
        m["abft/recomputes"] = self.retries
        return m

    # legacy field names, kept as views over the keyed counters ---------------

    @property
    def gemm_checks(self):
        return self.checks.get("qgemm", 0) + self.checks.get("float_gemm", 0)

    @property
    def gemm_errors(self):
        return self.errors.get("qgemm", 0) + self.errors.get("float_gemm", 0)

    @property
    def eb_checks(self):
        return self.checks.get("embedding_bag", 0)

    @property
    def eb_errors(self):
        return self.errors.get("embedding_bag", 0)


def empty_report() -> FaultReport:
    return FaultReport({n: 0 for n in _OP_KINDS}, {n: 0 for n in _OP_KINDS})


def op_report(name: str, err_count: Count, *, checks: Count = 1,
              retries: Count = 0, corrections: Count = 0) -> FaultReport:
    """A report with one op kind's counters set (all other kinds zero)."""
    if name not in _OP_KINDS:
        raise KeyError(f"unregistered op kind {name!r}; have {_OP_KINDS} "
                       "(register_op_kind at import time)")
    rep = empty_report()
    rep.checks[name] = checks
    rep.errors[name] = err_count
    rep.retries = retries
    rep.corrections = corrections
    return rep


def merge_reports(*reports: FaultReport) -> FaultReport:
    if not reports:
        return empty_report()
    names = sorted(set().union(*(r.checks.keys() for r in reports)))
    return FaultReport(
        {n: sum((r.checks.get(n, 0) for r in reports), 0) for n in names},
        {n: sum((r.errors.get(n, 0) for r in reports), 0) for n in names},
        sum((r.retries for r in reports), 0),
        sum((r.corrections for r in reports), 0))


def metrics_to_ints(metrics: dict) -> Dict[str, int]:
    """Land a metrics dict host-side: one device copy for all tensors."""
    keys = [k for k, v in metrics.items() if isinstance(v, torch.Tensor)]
    out = {k: int(v) for k, v in metrics.items() if k not in keys}
    if keys:
        vals = torch.stack([metrics[k].to(torch.int64).reshape(())
                            for k in keys]).tolist()
        out.update(zip(keys, vals))
    return out


def with_recompute(op: Callable, max_retries: int = 1):
    """Wrap an ABFT op ``op() -> (out, err)`` with detect->recompute.

    ``err`` is a count, or a vector of counts of independent checks (one
    per table of a stacked EmbeddingBag); only the entries that still
    report errors are replaced by the re-run, and each replaced entry is
    one retry — the sum a JAX ``vmap`` over per-table recomputes gives.
    Returns ``(out, err, retries)``.
    """
    def wrapped(*args, **kwargs):
        out, err = op(*args, **kwargs)
        retries = torch.zeros_like(err)
        for _ in range(max_retries):
            bad = err > 0
            if not bool(bad.any()):
                break
            out2, err2 = op(*args, **kwargs)
            shape = bad.shape + (1,) * (out.dim() - bad.dim())
            out = torch.where(bad.reshape(shape), out2, out)
            err = torch.where(bad, err2, err)
            retries = retries + bad.to(retries.dtype)
        return out, err, retries

    return wrapped


class FaultAbort(RuntimeError):
    """Raised by policy ``abort`` when an op reports errors."""


def is_fault_abort(exc: BaseException) -> bool:
    """True for a :class:`FaultAbort` (request boundaries gate on this,
    as they do in the JAX package)."""
    return isinstance(exc, FaultAbort)


def abort_if_errors(err) -> None:
    """Body of policy ``abort``."""
    n = int(torch.as_tensor(err).sum())
    if n > 0:
        raise FaultAbort(f"ABFT detected {n} corrupted op(s)")
