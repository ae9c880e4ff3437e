"""Campaign artifacts: ``BENCH_campaign_<name>.json`` + markdown summary.

The JSON artifact has the JAX package's schema (``campaign/artifacts.py``,
schema 1): it embeds the specs, every cell's plan + metrics, the
skipped-cell log, and the environment, so the two packages' loaders and
differs read each other's artifacts.  The environment names the device
the cells ran on.
"""
from __future__ import annotations

import json
import os
import platform
from typing import List, Optional

import torch

from repro_torch.campaign.metrics import CellMetrics
from repro_torch.campaign.spec import CampaignSpec

SCHEMA_VERSION = 1


def environment_info(device: torch.device, ranks: int = 1) -> dict:
    """The run's environment; ``ranks``: the processes of its world (a
    JAX run's forced host devices)."""
    on_card = device.type == "cuda"
    return {
        "ranks": ranks,
        "torch": torch.__version__,
        "backend": device.type,
        "device": (torch.cuda.get_device_name(device) if on_card
                   else platform.processor() or "cpu"),
        "device_count": torch.cuda.device_count() if on_card else 1,
        "python": platform.python_version(),
        "platform": platform.platform(),
    }


def campaign_to_dict(name: str, specs: List[CampaignSpec],
                     cells: List[dict], skipped: List[dict],
                     wall_s: float, seed: int,
                     device: torch.device, ranks: int = 1) -> dict:
    """``cells`` entries: {"plan": CellPlan, "metrics": CellMetrics,
    "seconds": float}."""
    return {
        "schema": SCHEMA_VERSION,
        "campaign": name,
        "seed": seed,
        "env": environment_info(device, ranks),
        "wall_seconds": wall_s,
        "specs": [s.to_dict() for s in specs],
        "skipped": skipped,
        "cells": [{
            "cell_id": c["plan"].cell_id,
            "plan": c["plan"].to_dict(),
            "metrics": c["metrics"].to_dict(),
            "seconds": c["seconds"],
        } for c in cells],
    }


def write_artifacts(result: dict, out_dir: str = ".") -> tuple:
    """Write JSON + markdown; returns (json_path, md_path), named by the
    campaign so runs line up file for file."""
    os.makedirs(out_dir, exist_ok=True)
    base = f"BENCH_campaign_{result['campaign']}"
    json_path = os.path.join(out_dir, base + ".json")
    md_path = os.path.join(out_dir, base + ".md")
    with open(json_path, "w") as f:
        json.dump(result, f, indent=2, sort_keys=True)
        f.write("\n")
    with open(md_path, "w") as f:
        f.write(markdown_table(result))
        lat = latency_markdown(result)
        if lat:
            f.write("\n" + lat)
        bd = breakdown_markdown(result)
        if bd:
            f.write("\n" + bd)
    return json_path, md_path


def load_artifact(path: str) -> dict:
    with open(path) as f:
        result = json.load(f)
    if result.get("schema") != SCHEMA_VERSION:
        raise ValueError(
            f"artifact schema {result.get('schema')} != {SCHEMA_VERSION}")
    return result


def cell_metrics(result: dict, cell_id: str) -> CellMetrics:
    for c in result["cells"]:
        if c["cell_id"] == cell_id:
            return CellMetrics.from_dict(c["metrics"])
    raise KeyError(f"no cell {cell_id!r} in artifact "
                   f"{result.get('campaign')!r}")


def find_cells(result: dict, **field_values) -> List[dict]:
    """Filter cells by plan fields, e.g. ``target="gemm_packed",
    fault_model="bitflip"``."""
    return [c for c in result["cells"]
            if all(c["plan"].get(k) == v for k, v in field_values.items())]


def _fmt_pct(x: Optional[float]) -> str:
    return "—" if x is None else f"{100.0 * x:.2f}%"


def _env_line(result: dict) -> str:
    env = result["env"]
    lib = f"torch {env['torch']}" if "torch" in env else f"jax {env['jax']}"
    where = env.get("device") or env["backend"]
    return (f"seed {result['seed']} · {env['backend']} {where} "
            f"×{env['device_count']} · {lib} · "
            f"{result['wall_seconds']:.1f}s wall")


def markdown_table(result: dict) -> str:
    lines = [
        f"# Resilience campaign `{result['campaign']}`",
        "",
        _env_line(result),
        "",
        "| cell | n | detect | escape | FP | bound | overhead |",
        "|---|---|---|---|---|---|---|",
    ]
    for c in result["cells"]:
        m = c["metrics"]
        lines.append(
            "| `{cid}` | {n} | {det} | {esc} | {fp} | {bound} | {ov} |"
            .format(
                cid=c["cell_id"], n=m["samples"],
                det=_fmt_pct(m["detection_rate"]),
                esc=_fmt_pct(m["escape_rate"]),
                fp=_fmt_pct(m["fp_rate"]),
                bound=_fmt_pct(m.get("analytic_bound")),
                ov=_fmt_pct(m.get("overhead"))))
    if result.get("skipped"):
        lines += ["", f"Skipped cells: {len(result['skipped'])}", ""]
        for s in result["skipped"]:
            lines.append(f"- `{s['cell_id']}`: {s['reason']}")
    lines.append("")
    return "\n".join(lines)


def latency_markdown(result: dict) -> str:
    """Detection-latency + divergence summary for soak-protocol cells
    (those carrying ``steps``), as the JAX package renders it: the
    histogram column reads ``t0:n0 t1:n1 ...`` — n trials first detected
    t steps after the upset; the shards column is ``N✓`` when the cell's
    collective was verified, with per-shard attribution in brackets.
    Empty when no cell has the soak columns (every grid the port runs
    today: its targets are single-shot)."""
    lines = ["# Soak cells: detection latency & divergence", "",
             "| cell | steps | shards | latency hist | mean lat |"
             " div (mean/max) | loss div |",
             "|---|---|---|---|---|---|---|"]
    found = False
    for c in result["cells"]:
        m = c["metrics"]
        if m.get("steps") is None:
            continue
        found = True
        hist = m.get("detection_latency_hist") or []
        hist_s = " ".join(f"{t}:{n}" for t, n in enumerate(hist) if n) \
            or "—"
        lat = m.get("mean_detection_latency")
        shards_s = "—" if m.get("shards") is None else str(m["shards"])
        if m.get("collective_verified"):
            shards_s += "✓"
            if m.get("shard_detections"):
                shards_s += " [{}]".format(
                    " ".join(str(n) for n in m["shard_detections"]))
        lines.append(
            "| `{cid}` | {steps} | {sh} | {hist} | {lat} | "
            "{dm:.2e}/{dx:.2e} | {ld:.2e} |".format(
                cid=c["cell_id"], steps=m["steps"], sh=shards_s,
                hist=hist_s,
                lat="—" if lat is None else f"{lat:.2f}",
                dm=m.get("divergence_mean") or 0.0,
                dx=m.get("divergence_max") or 0.0,
                ld=m.get("loss_divergence_mean") or 0.0))
    if not found:
        return ""
    lines.append("")
    return "\n".join(lines)


def breakdown_markdown(result: dict) -> str:
    """Per-phase overhead accounting for cells that measured it: median
    ms and the phase's share of the cell's phase total per column (the
    union of the cells' phase names); empty when no cell measured it."""
    rows = [(c["cell_id"], c["metrics"]["overhead_breakdown"])
            for c in result["cells"]
            if c["metrics"].get("overhead_breakdown")]
    if not rows:
        return ""
    phases: List[str] = []
    for _, bd in rows:
        for name in bd:
            if name not in phases:
                phases.append(name)
    lines = ["# Protection overhead breakdown (median ms / share)", "",
             "| cell | " + " | ".join(phases) + " |",
             "|---|" + "---|" * len(phases)]
    for cid, bd in rows:
        total = sum(bd.values()) or 1.0
        cols = []
        for name in phases:
            v = bd.get(name)
            cols.append("—" if v is None else
                        f"{1e3 * v:.3f} ({100.0 * v / total:.0f}%)")
        lines.append(f"| `{cid}` | " + " | ".join(cols) + " |")
    lines.append("")
    return "\n".join(lines)


def threshold_curve(result: dict, target: str = "embedding_bag") -> dict:
    """Detection-vs-FP tradeoff per bit band from a rel_bound sweep.

    Returns ``{band: [(rel_bound, detection_rate, fp_rate), ...]}`` sorted
    by bound — the curve the ``thresholds`` grid exists to produce."""
    curves: dict = {}
    for c in result["cells"]:
        if c["plan"].get("target") != target:
            continue
        rb = c["plan"].get("rel_bound")
        if rb is None:
            continue
        m = c["metrics"]
        curves.setdefault(c["plan"]["bit_band"], []).append(
            (rb, m["detection_rate"], m["fp_rate"]))
    return {band: sorted(pts) for band, pts in curves.items()}


def threshold_curve_markdown(result: dict,
                             target: str = "embedding_bag") -> str:
    curves = threshold_curve(result, target)
    lines = [f"# EB rel_bound tradeoff curves (`{target}`)", ""]
    for band, pts in sorted(curves.items()):
        lines += [f"## band `{band}`", "",
                  "| rel_bound | detection | false positives |",
                  "|---|---|---|"]
        for rb, det, fp in pts:
            lines.append(f"| {rb:g} | {_fmt_pct(det)} | {_fmt_pct(fp)} |")
        lines.append("")
    return "\n".join(lines)


__all__ = ["campaign_to_dict", "write_artifacts", "load_artifact",
           "cell_metrics", "find_cells", "markdown_table",
           "latency_markdown", "breakdown_markdown", "threshold_curve",
           "threshold_curve_markdown", "environment_info",
           "SCHEMA_VERSION"]
