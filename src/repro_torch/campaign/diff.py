"""Artifact differ: flag detection-rate / FP / overhead regressions
between two ``BENCH_campaign_*.json`` files (a copy of the JAX package's
``campaign/diff.py``, which reads either package's artifacts), plus the
statistical gate :func:`wilson_gate`.

    python -m repro_torch.campaign --diff OLD.json NEW.json

Cells are matched by ``cell_id``.  A **regression** is:

* new effective detection rate below old by more than ``det_tol``;
* new false-positive rate above old by more than ``fp_tol``;
* (only when ``overhead_tol`` is given — wall-clock overhead is noisy on
  shared CI runners, so it is opt-in) new overhead above old by more than
  ``overhead_tol``;
* a cell present in the old artifact but missing from the new one
  (silent coverage loss reads as "no regressions" when it is the worst
  kind).

Detection counts are deterministic per seed and package, so the default
tolerances mostly absorb cross-version drift.  Two packages draw their
faults from different generators, so between them a cell's rate differs by
sampling alone: :func:`wilson_gate` holds each cell to overlapping 95%
Wilson intervals instead.  The CLI exits nonzero iff regressions exist.
"""
from __future__ import annotations

from typing import List, Optional

from repro_torch.campaign.artifacts import load_artifact
from repro_torch.campaign.metrics import wilson_interval


def _cells_by_id(result: dict) -> dict:
    return {c["cell_id"]: c["metrics"] for c in result["cells"]}


def diff_artifacts(old: dict, new: dict, *, det_tol: float = 0.02,
                   fp_tol: float = 0.02,
                   overhead_tol: Optional[float] = None) -> dict:
    """Compare two loaded artifacts; returns the diff record.

    ``{"regressions": [...], "improvements": [...], "added": [...],
    "removed": [...], "unchanged": int, "old": name, "new": name}`` —
    regression entries carry ``cell_id``, ``kind``, ``old``/``new`` values
    and the tolerance that was exceeded.
    """
    oc, nc = _cells_by_id(old), _cells_by_id(new)
    regressions: List[dict] = []
    improvements: List[dict] = []
    unchanged = 0

    for cid in sorted(set(oc) & set(nc)):
        om, nm = oc[cid], nc[cid]
        flagged = False

        d_old, d_new = om["detection_rate"], nm["detection_rate"]
        if d_new < d_old - det_tol:
            regressions.append({"cell_id": cid, "kind": "detection_rate",
                                "old": d_old, "new": d_new,
                                "tol": det_tol})
            flagged = True
        elif d_new > d_old + det_tol:
            improvements.append({"cell_id": cid, "kind": "detection_rate",
                                 "old": d_old, "new": d_new})
            flagged = True

        f_old, f_new = om["fp_rate"], nm["fp_rate"]
        if f_new > f_old + fp_tol:
            regressions.append({"cell_id": cid, "kind": "fp_rate",
                                "old": f_old, "new": f_new, "tol": fp_tol})
            flagged = True
        elif f_new < f_old - fp_tol:
            improvements.append({"cell_id": cid, "kind": "fp_rate",
                                 "old": f_old, "new": f_new})
            flagged = True

        o_old, o_new = om.get("overhead"), nm.get("overhead")
        if overhead_tol is not None and o_old is not None \
                and o_new is not None:
            if o_new > o_old + overhead_tol:
                regressions.append({"cell_id": cid, "kind": "overhead",
                                    "old": o_old, "new": o_new,
                                    "tol": overhead_tol})
                flagged = True
            elif o_new < o_old - overhead_tol:
                improvements.append({"cell_id": cid, "kind": "overhead",
                                     "old": o_old, "new": o_new})
                flagged = True

        # unchanged = neither regressed nor improved (counts must add up)
        if not flagged:
            unchanged += 1

    removed = sorted(set(oc) - set(nc))
    for cid in removed:
        regressions.append({"cell_id": cid, "kind": "coverage",
                            "old": oc[cid]["detection_rate"], "new": None,
                            "tol": None})
    return {
        "old": old.get("campaign"), "new": new.get("campaign"),
        "regressions": regressions,
        "improvements": improvements,
        "added": sorted(set(nc) - set(oc)),
        "removed": removed,
        "unchanged": unchanged,
    }


def _overlap(old: tuple, new: tuple) -> bool:
    return max(old[0], new[0]) <= min(old[1], new[1])


def wilson_gate(old: dict, new: dict, *, z: float = 1.96) -> dict:
    """Hold every cell of ``new`` that ``old`` also has to ``old`` by
    overlapping Wilson intervals: the effective detection rate (detected
    or masked over faulty trials; a cell that counts no masked trials,
    as the ``paging`` grid's, its detected ones) and the false-positive
    rate (flags over clean trials), and for the ``serving_soak`` grid the
    escape rate (corrupted and unflagged faults over faults).  Returns
    ``{"cells": [...], "failed": [cell_id, ...], "uncovered": [cell_id,
    ...]}``; each cell entry carries both intervals of each metric and
    whether they overlap."""
    def count(m, k):
        return m[k] if k in m else m["detected"]

    oc, nc = _cells_by_id(old), _cells_by_id(new)
    cells, failed = [], []
    for cid in sorted(set(oc) & set(nc)):
        entry = {"cell_id": cid}
        metrics = [("detection", "effective_detected", "samples"),
                   ("fp", "false_positives", "clean_samples")]
        if old.get("campaign") == new.get("campaign") == "serving_soak":
            metrics.append(("escape", "escapes", "samples"))
        for metric, k, n in metrics:
            a = wilson_interval(count(oc[cid], k), oc[cid][n], z)
            b = wilson_interval(count(nc[cid], k), nc[cid][n], z)
            entry[metric] = {"old": list(a), "new": list(b),
                             "overlap": _overlap(a, b)}
        cells.append(entry)
        if not all(entry[m]["overlap"] for m, _, _ in metrics):
            failed.append(cid)
    return {"cells": cells, "failed": failed,
            "uncovered": sorted(set(oc) - set(nc))}


def _fmt(x) -> str:
    return "—" if x is None else f"{100.0 * x:.2f}%"


def format_diff(diff: dict) -> str:
    """Markdown rendering (CI uploads this next to the artifacts)."""
    lines = [
        f"# Campaign diff: `{diff['old']}` -> `{diff['new']}`",
        "",
        f"{len(diff['regressions'])} regression(s), "
        f"{len(diff['improvements'])} improvement(s), "
        f"{diff['unchanged']} unchanged, {len(diff['added'])} added, "
        f"{len(diff['removed'])} removed",
    ]
    if diff["regressions"]:
        lines += ["", "## Regressions", "",
                  "| cell | metric | old | new |", "|---|---|---|---|"]
        for r in diff["regressions"]:
            lines.append(f"| `{r['cell_id']}` | {r['kind']} | "
                         f"{_fmt(r['old'])} | {_fmt(r['new'])} |")
    if diff["improvements"]:
        lines += ["", "## Improvements", "",
                  "| cell | metric | old | new |", "|---|---|---|---|"]
        for r in diff["improvements"]:
            lines.append(f"| `{r['cell_id']}` | {r['kind']} | "
                         f"{_fmt(r['old'])} | {_fmt(r['new'])} |")
    if diff["added"]:
        lines += ["", "New cells: " + ", ".join(
            f"`{c}`" for c in diff["added"])]
    lines.append("")
    return "\n".join(lines)


def run_diff(old_path: str, new_path: str, *, det_tol: float = 0.02,
             fp_tol: float = 0.02, overhead_tol: Optional[float] = None,
             out_path: Optional[str] = None,
             emit=print) -> int:
    """CLI body: load, diff, print/write markdown; 1 iff regressions."""
    diff = diff_artifacts(load_artifact(old_path), load_artifact(new_path),
                          det_tol=det_tol, fp_tol=fp_tol,
                          overhead_tol=overhead_tol)
    md = format_diff(diff)
    emit(md)
    if out_path:
        with open(out_path, "w") as f:
            f.write(md)
    return 1 if diff["regressions"] else 0


__all__ = ["diff_artifacts", "format_diff", "run_diff", "wilson_gate"]
