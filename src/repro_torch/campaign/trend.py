"""Longitudinal detection-quality trend gate.

``--diff`` compares exactly two artifacts; this module folds an ordered
series — the committed ``benchmarks/baselines/BENCH_campaign_*.json``
plus a fresh run — into a per-cell history, renders the markdown history
table, and gates the NEWEST entry of each cell against the median of its
prior entries:

* detection rate below the prior median by more than ``det_tol``;
* false-positive rate above the prior median by more than ``fp_tol``;
* (opt-in, wall-clock noise) overhead above the prior median by more
  than ``latency_tol``;
* a cell present in a campaign's previous artifact but missing from its
  newest one (coverage loss).

The median reference is what makes this the *longitudinal* counterpart
of ``--diff``: one noisy historical entry cannot move the gate the way
it would move a pairwise comparison.  Cells with a single entry are
listed but not gated.

    python -m repro_torch.campaign --trend               # baselines only
    python -m repro_torch.campaign --trend BASE1.json ... NEW.json
"""
from __future__ import annotations

import glob
import os
import statistics
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.campaign.artifacts import load_artifact

#: where the committed longitudinal baselines live (repo-relative)
DEFAULT_BASELINE_GLOB = os.path.join("benchmarks", "baselines",
                                     "BENCH_campaign_*.json")


def default_baseline_paths(root: str = ".") -> List[str]:
    return sorted(glob.glob(os.path.join(root, DEFAULT_BASELINE_GLOB)))


def load_history(paths: Sequence[str]) -> Dict[str, List[Tuple[str, dict]]]:
    """paths (oldest -> newest) -> {campaign: [(label, cells_by_id), ...]}.

    Two artifacts of the same campaign name are two chronological
    versions; different campaigns gate independently (their cell ids
    never compare against each other even if they collide)."""
    campaigns: Dict[str, List[Tuple[str, dict]]] = {}
    for path in paths:
        art = load_artifact(path)
        cells = {c["cell_id"]: c["metrics"] for c in art["cells"]}
        campaigns.setdefault(art["campaign"], []).append(
            (os.path.basename(path), cells))
    return campaigns


def _cell_order(versions: List[Tuple[str, dict]]) -> List[str]:
    seen: Dict[str, None] = {}
    for _, cells in versions:
        for cid in cells:
            seen.setdefault(cid)
    return list(seen)


def trend_gate(history: Dict[str, List[Tuple[str, dict]]], *,
               det_tol: float = 0.02, fp_tol: float = 0.02,
               latency_tol: Optional[float] = None) -> dict:
    """Gate each cell's newest entry against the median of its priors."""
    regressions: List[dict] = []
    improvements: List[dict] = []
    gated = single = 0
    for campaign, versions in history.items():
        if len(versions) < 2:
            single += sum(1 for _ in _cell_order(versions))
            continue
        last_label, last_cells = versions[-1]
        prev_cells = versions[-2][1]
        for cid in _cell_order(versions):
            entries = [cells[cid] for _, cells in versions
                       if cid in cells]
            if cid not in last_cells:
                if cid in prev_cells:
                    regressions.append({
                        "campaign": campaign, "cell_id": cid,
                        "kind": "coverage",
                        "ref": prev_cells[cid]["detection_rate"],
                        "new": None, "tol": None})
                continue
            if len(entries) < 2:
                single += 1
                continue
            gated += 1
            cur = last_cells[cid]
            priors = entries[:-1]

            def check(kind, tol, sign):
                if tol is None:
                    return
                vals = [m.get(kind) for m in priors]
                vals = [v for v in vals if v is not None]
                if not vals or cur.get(kind) is None:
                    return
                ref = statistics.median(vals)
                delta = sign * (cur[kind] - ref)
                row = {"campaign": campaign, "cell_id": cid,
                       "kind": kind, "ref": ref, "new": cur[kind],
                       "tol": tol}
                if delta < -tol:
                    regressions.append(row)
                elif delta > tol:
                    improvements.append(row)

            check("detection_rate", det_tol, +1)   # drop = regression
            check("fp_rate", fp_tol, -1)           # rise = regression
            check("overhead", latency_tol, -1)     # rise = regression
    return {"regressions": regressions, "improvements": improvements,
            "gated_cells": gated, "ungated_cells": single}


def _fmt(x) -> str:
    return "—" if x is None else f"{100.0 * x:.2f}%"


def format_trend(history: Dict[str, List[Tuple[str, dict]]],
                 report: dict) -> str:
    """The markdown history table + the gate verdict."""
    n_arts = sum(len(v) for v in history.values())
    lines = [f"# Detection-quality trend ({n_arts} artifact(s), "
             f"{len(history)} campaign(s))", ""]
    for campaign, versions in history.items():
        labels = [label for label, _ in versions]
        lines += [f"## campaign `{campaign}`", "",
                  "versions (oldest → newest): "
                  + " → ".join(f"`{v}`" for v in labels), "",
                  "| cell | " + " | ".join(
                      f"v{i} det/fp" for i in range(len(labels)))
                  + " | Δdet |",
                  "|---|" + "---|" * (len(labels) + 1)]
        for cid in _cell_order(versions):
            cols = []
            rates = []
            for _, cells in versions:
                m = cells.get(cid)
                if m is None:
                    cols.append("—")
                else:
                    cols.append(f"{_fmt(m['detection_rate'])}/"
                                f"{_fmt(m['fp_rate'])}")
                    rates.append(m["detection_rate"])
            delta = (f"{100.0 * (rates[-1] - rates[0]):+.2f}pp"
                     if len(rates) >= 2 else "—")
            lines.append(f"| `{cid}` | " + " | ".join(cols)
                         + f" | {delta} |")
        lines.append("")
    lines.append(f"{report['gated_cells']} cell(s) gated against their "
                 f"history, {report['ungated_cells']} with a single "
                 f"entry (listed, not gated)")
    if report["regressions"]:
        lines += ["", "## Trend regressions", "",
                  "| campaign | cell | metric | prior median | new |",
                  "|---|---|---|---|---|"]
        for r in report["regressions"]:
            lines.append(f"| {r['campaign']} | `{r['cell_id']}` | "
                         f"{r['kind']} | {_fmt(r['ref'])} | "
                         f"{_fmt(r['new'])} |")
    else:
        lines += ["", "No trend regressions."]
    if report["improvements"]:
        lines += ["", "## Trend improvements", "",
                  "| campaign | cell | metric | prior median | new |",
                  "|---|---|---|---|---|"]
        for r in report["improvements"]:
            lines.append(f"| {r['campaign']} | `{r['cell_id']}` | "
                         f"{r['kind']} | {_fmt(r['ref'])} | "
                         f"{_fmt(r['new'])} |")
    lines.append("")
    return "\n".join(lines)


def run_trend(paths: Sequence[str], *, det_tol: float = 0.02,
              fp_tol: float = 0.02, latency_tol: Optional[float] = None,
              out_path: Optional[str] = None, emit=print) -> int:
    """CLI body: load, gate, print/write markdown; 1 iff regressions."""
    paths = list(paths) or default_baseline_paths()
    if not paths:
        emit("no artifacts found (pass paths or run from the repo root "
             "so the committed baselines glob resolves)")
        return 2
    history = load_history(paths)
    report = trend_gate(history, det_tol=det_tol, fp_tol=fp_tol,
                        latency_tol=latency_tol)
    md = format_trend(history, report)
    emit(md)
    if out_path:
        with open(out_path, "w") as f:
            f.write(md)
    return 1 if report["regressions"] else 0


__all__ = ["load_history", "trend_gate", "format_trend", "run_trend",
           "default_baseline_paths", "DEFAULT_BASELINE_GLOB"]
