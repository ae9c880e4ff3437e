"""Roofline tables on the H100 (the JAX package's
``benchmarks/roofline_table.py``, there for TPU v5e).

    python -m repro_torch.benchmarks.roofline_table [--art-dir DIR]
        [--quick]

* **The dry run's cells.**  Reads ``<art-dir>/*.json``
  (:mod:`repro_torch.launch.dryrun`'s records) and gives JAX's columns
  per (arch x shape x mesh) cell: the three roofline terms, the dominant
  one, MODEL_FLOPS over the counted flops, the per-device peak and
  whether it fits the card's memory, ``torch.cuda.get_device_properties
  (0).total_memory`` where a card is present, else
  :data:`H100_TOTAL_MEMORY`, the figure that call read on an NVIDIA H100
  80GB HBM3 in ``chip_smoke.py`` phase 22.
* **The ABFT implementation roofline** of Fig. 5's 28 DLRM GEMM shapes,
  with no artifacts: per shape the bytes each program must move and its
  least time on the card, for the unprotected instance (A, B and C
  once), K1 (the verify in its epilogue: B''s checksum column and the
  err vector, :func:`~repro_torch.benchmarks.gemm_overhead.extra_bytes`)
  and the plain unfused path (which writes the product with its
  checksum column and reads it back: 4 m (n + 128) more), each against
  the unprotected bound.  Int8 operations go at the card's int8 rate.

In ``python -m repro_torch.benchmarks.run`` it is the ``roofline_table``
bench: the ABFT rows, and the dry-run rows where ``artifacts/dryrun``
holds records.
"""
from __future__ import annotations

import argparse
import glob
import json
import os
import sys
from typing import List

from repro_torch.benchmarks.common import (GEMM_SHAPES, INT8_OPS_PER_S,
                                           bound_ms, markdown, pct)
from repro_torch.benchmarks.gemm_overhead import (extra_bytes,
                                                  unprotected_bytes)
from repro_torch.core import LANE

#: ``torch.cuda.get_device_properties(0).total_memory`` of an NVIDIA H100
#: 80GB HBM3, as ``chip_smoke.py`` phase 22 reads it
H100_TOTAL_MEMORY = 85_017_493_504

ART_DIR = "artifacts/dryrun"
INSTANCES = ("unprotected", "K1", "unfused")


def card_memory() -> tuple:
    """(bytes a device holds, where the figure comes from): the card's,
    else :data:`H100_TOTAL_MEMORY`."""
    import torch
    if torch.cuda.is_available():
        return (torch.cuda.get_device_properties(0).total_memory,
                f"total_memory of {torch.cuda.get_device_name(0)}")
    return H100_TOTAL_MEMORY, "the H100 80GB HBM3's total_memory"


def load_cells(art_dir: str = ART_DIR) -> List[dict]:
    cells = []
    for path in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(path) as f:
            cells.append(json.load(f))
    return cells


def dryrun_rows(cells: List[dict], hbm: int) -> List[dict]:
    """JAX's columns for each record."""
    rows = []
    for c in cells:
        row = {"arch": c["arch"], "shape": c["shape"], "mesh": c["mesh"],
               "status": c["status"]}
        if c["status"] == "skipped":
            row["note"] = c["skip_reason"].split(":")[0]
        elif c["status"] != "ok":
            row["note"] = c.get("error", "")[:60]
        else:
            r = c["roofline"]
            peak = c["memory_per_device"]["peak_estimate_bytes"]
            row.update(compute_s=r["compute_s"], memory_s=r["memory_s"],
                       collective_s=r["collective_s"],
                       dominant=r["dominant"],
                       model_vs_counted=c.get("model_vs_hlo"),
                       peak_bytes=peak, fits=peak <= hbm,
                       argument_bytes=c["memory_per_device"][
                           "argument_bytes"])
        rows.append(row)
    return rows


def dryrun_table(rows: List[dict], hbm: int, source: str) -> str:
    body = []
    for r in rows:
        if r["status"] != "ok":
            body.append((r["arch"], r["shape"], r["mesh"],
                         r["status"].upper(), "-", "-", "-", "-", "-",
                         r.get("note", "")))
            continue
        ratio = r["model_vs_counted"]
        body.append((r["arch"], r["shape"], r["mesh"],
                     f"{r['compute_s']:.3e}", f"{r['memory_s']:.3e}",
                     f"{r['collective_s']:.3e}", r["dominant"],
                     f"{ratio:.2f}" if ratio else "-",
                     f"{r['peak_bytes'] / 2**30:.1f} GiB",
                     "fits" if r["fits"] else "OOM!"))
    return markdown(
        f"Dry-run roofline on the H100 (per device; fits against "
        f"{hbm / 2**30:.2f} GiB, {source})",
        ["arch", "shape", "mesh", "compute_s", "memory_s", "collective_s",
         "dominant", "model/counted", "peak", "hbm"], body)


def abft_traffic(m: int, n: int, k: int, instance: str) -> dict:
    """(ops, bytes) one call of ``instance`` must do and move."""
    ub = unprotected_bytes(m, n, k)
    if instance == "unprotected":
        return {"ops": 2.0 * m * n * k, "bytes": float(ub)}
    ops = 2.0 * m * (n + 1) * k + 3.0 * m * (n + 1)
    if instance == "K1":
        return {"ops": ops, "bytes": float(ub + extra_bytes(m, n, k))}
    if instance == "unfused":
        return {"ops": ops, "bytes": float(ub + extra_bytes(m, n, k)
                                           + 4 * m * (n + LANE))}
    raise ValueError(instance)


def abft_rows(quick: bool = False) -> List[dict]:
    """Three rows a Fig. 5 shape: the instance's ops, bytes, the bytes
    beyond the unprotected instance's, its bound and that bound over
    the unprotected one."""
    rows = []
    for m, n, k in (GEMM_SHAPES[::4] if quick else GEMM_SHAPES):
        base, _ = bound_ms(unprotected_bytes(m, n, k), 2.0 * m * n * k,
                           INT8_OPS_PER_S)
        for inst in INSTANCES:
            t = abft_traffic(m, n, k, inst)
            ms, by = bound_ms(t["bytes"], t["ops"], INT8_OPS_PER_S)
            rows.append({"shape": (m, n, k), "instance": inst,
                         "ops": t["ops"], "bytes": t["bytes"],
                         "extra_bytes": t["bytes"]
                         - unprotected_bytes(m, n, k),
                         "bound_ms": ms, "bound_by": by,
                         "bound_overhead": ms / base - 1.0})
    return rows


def abft_table(rows: List[dict]) -> str:
    body = [("×".join(map(str, r["shape"])), r["instance"],
             f"{r['ops']:.3e}", f"{r['bytes']:.3e}",
             "-" if r["instance"] == "unprotected"
             else f"{r['extra_bytes']:.3e}",
             f"{r['bound_ms']:.5f}", r["bound_by"],
             pct(r["bound_overhead"])) for r in rows]
    return markdown(
        "ABFT implementation roofline on the H100 (least ms a call, "
        "3.35 TB/s, 1979 int8 TOP/s)",
        ["m×n×k", "instance", "ops", "bytes", "extra bytes", "bound ms",
         "bound by", "bound overhead"], body)


def run(device="cpu", *, quick: bool = False, timer=None) -> List[dict]:
    """The ``roofline_table`` bench of :mod:`repro_torch.benchmarks.run`:
    the ABFT rows (arithmetic only; ``device`` and ``timer`` unused) and
    the dry-run rows of :data:`ART_DIR`'s records."""
    hbm, _ = card_memory()
    return abft_rows(quick) + dryrun_rows(load_cells(), hbm)


def table(rows: List[dict], clock: str = "device") -> str:
    del clock
    hbm, source = card_memory()
    abft = [r for r in rows if "instance" in r]
    cells = [r for r in rows if "instance" not in r]
    out = abft_table(abft)
    if cells:
        out += "\n" + dryrun_table(cells, hbm, source)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.roofline_table",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--art-dir", default=ART_DIR)
    ap.add_argument("--quick", action="store_true",
                    help="every fourth GEMM shape")
    args = ap.parse_args(argv)
    hbm, source = card_memory()
    print(abft_table(abft_rows(args.quick)))
    cells = load_cells(args.art_dir)
    if cells:
        print(dryrun_table(dryrun_rows(cells, hbm), hbm, source))
    else:
        print(f"(no dry-run records under {args.art_dir}: python -m "
              f"repro_torch.launch.dryrun --out {args.art_dir})")
    return 0


if __name__ == "__main__":
    sys.exit(main())


__all__ = ["H100_TOTAL_MEMORY", "INSTANCES", "card_memory", "load_cells",
           "dryrun_rows", "dryrun_table", "abft_traffic", "abft_rows",
           "abft_table", "run", "table", "main"]
