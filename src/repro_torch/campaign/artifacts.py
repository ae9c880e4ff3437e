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

from repro_torch.campaign.spec import CampaignSpec

SCHEMA_VERSION = 1


def environment_info(device: torch.device) -> dict:
    on_card = device.type == "cuda"
    return {
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
                     device: torch.device) -> dict:
    """``cells`` entries: {"plan": CellPlan, "metrics": CellMetrics,
    "seconds": float}."""
    return {
        "schema": SCHEMA_VERSION,
        "campaign": name,
        "seed": seed,
        "env": environment_info(device),
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


__all__ = ["campaign_to_dict", "write_artifacts", "load_artifact",
           "markdown_table", "breakdown_markdown", "environment_info",
           "SCHEMA_VERSION"]
