"""Collective accounting of a dry-run cell (the JAX package's
``launch/hlo.py``).

JAX parses the compiled HLO text and sums the **result** bytes of every
collective (an all-gather at its gathered size, an all-reduce at its
tensor size, a reduce-scatter at its scattered shard).  The port's
:class:`~repro_torch.launch.costs.CostCounter` records each collective
as it runs, with the same convention; :func:`collective_stats` sums its
log by kind.

JAX's ``scan_trip_counts`` counts ``while(`` in the HLO text.  An eager
program has no loop construct to count: its loops are Python loops,
whose every trip the counter sees, so it has no counterpart here.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable


def collective_stats(log: Iterable[tuple]) -> Dict[str, dict]:
    """``{kind: {count, bytes}}`` and ``total`` over a counter's
    ``collective_log`` (``(kind, raw result bytes, group size)`` a
    collective)."""
    stats: Dict[str, dict] = defaultdict(lambda: {"count": 0, "bytes": 0})
    for kind, raw, _g in log:
        stats[kind]["count"] += 1
        stats[kind]["bytes"] += int(raw)
    out = dict(stats)
    out["total"] = {"count": sum(v["count"] for v in stats.values()),
                    "bytes": sum(v["bytes"] for v in stats.values())}
    return out


__all__ = ["collective_stats"]
