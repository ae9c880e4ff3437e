"""Table I / Fig. 6 on the card: the ABFT EmbeddingBag's overhead (the
JAX package's ``benchmarks/eb_overhead.py``).

The paper's settings: 4M-row int8 tables, d in {32, 64, 128, 256},
pooling 100, batch 10, regular and weighted sums; alphas ~ U(1e-3, 2e-3)
and betas ~ U(-1e-2, 1e-2), as the JAX benchmark draws them.  Two
programs a cell, each one launch:

* ``unprotected`` — K2's unprotected instance: R alone, through the same
  plan and loops (the counterpart of ``core.embedding_bag``, the JAX
  benchmark's baseline);
* ``abft`` — K2: R with the C_T gather, rsum and the Eq. (5) compare and
  count fused in.

Each is timed by CUDA events over back-to-back launches in alternating
rounds, every launch with fresh random indices (and weights), so its rows
come from HBM, as the paper flushes its cache.  The overhead of a round
is ``abft / unprotected - 1``; a cell reports the median of the rounds
and their spread, beside the paper's analytic ``1/d + 1/(3 pool)``
(§V-C) and the bytes the check adds, from the shapes: C_T per slot, and
rsum, the flags and the count.  Every cell also holds the unprotected R
bit-exact to the protected kernel's.
"""
from __future__ import annotations

import itertools
from typing import List

import torch

from repro_torch.benchmarks.common import (F32_OPS_PER_S, ROUNDS, alternate,
                                           bound_ms, make_timer, markdown,
                                           overhead, pct, spread)
from repro_torch.core import table_rowsums
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

ROWS = 4_000_000
DIMS = (32, 64, 128, 256)
POOL = 100
BATCH = 10
#: launches per timing on the card
LAUNCHES = 100


def unprotected_bytes(d: int, weighted: bool, bags: int = BATCH,
                      pool: int = POOL) -> int:
    """Indices, rows, alpha and beta (and weights) per slot, and R."""
    slots = bags * pool
    return slots * (4 + d + 8 + (4 if weighted else 0)) + 4 * bags * d


def extra_bytes(bags: int = BATCH, pool: int = POOL) -> int:
    """C_T per slot, rsum and a flag per bag, and the table's count."""
    return 4 * bags * pool + 5 * bags + 4


def analytic(d: int, pool: int = POOL) -> float:
    """The paper's §V-C overhead model."""
    return 1 / d + 1 / (3 * pool)


def make_table(rows: int, d: int, device) -> tuple:
    """One int8 table [1, rows, d] with its scales and C_T, made on the
    device from seed ``d``."""
    gen = torch.Generator(device=device).manual_seed(d)
    table = torch.randint(-128, 128, (1, rows, d), dtype=torch.int8,
                          generator=gen, device=device)
    alphas = torch.empty((1, rows), device=device).uniform_(
        1e-3, 2e-3, generator=gen)
    betas = torch.empty((1, rows), device=device).uniform_(
        -1e-2, 1e-2, generator=gen)
    return table, alphas, betas, table_rowsums(table)


def run_cell(enc, d: int, weighted: bool, *, device, timer,
             launches: int, seed: int = 0) -> dict:
    table, alphas, betas, rowsums = enc
    rows = table.shape[1]
    # every call takes fresh bags: Timer.ms makes 2n + 1 calls, the host
    # timer n + 1, for each of the two programs in every round
    sets = ROUNDS * 2 * (2 * launches + 1)
    gen = torch.Generator(device=device).manual_seed(seed * 1000 + d)
    idx = torch.randint(0, rows, (sets, 1, BATCH, POOL), dtype=torch.int32,
                        generator=gen, device=device)
    w = (torch.empty((sets, 1, BATCH, POOL), device=device).uniform_(
        0.5, 1.5, generator=gen) if weighted else None)

    def bags(i):
        return idx[i], None if w is None else w[i]

    def protected(i):
        x, ww = bags(i)
        return kops.abft_embedding_bag(table, alphas, betas, x, rowsums, ww)

    r_un = kops.embedding_bag_unprotected(table, alphas, betas, *bags(0))
    out = protected(0)
    exact = bool(torch.equal(r_un, out.r)) and not bool(out.err_bags.any())
    nxt = itertools.cycle(range(sets)).__next__
    times = alternate(timer, {
        "unprotected": lambda: kops.embedding_bag_unprotected(
            table, alphas, betas, *bags(nxt())),
        "abft": lambda: protected(nxt()),
    }, launches)
    ub = unprotected_bytes(d, weighted)
    b_ms, b_by = bound_ms(ub, 3 * BATCH * POOL * d, F32_OPS_PER_S)
    return {
        "d": d, "mode": "weighted" if weighted else "regular", "rows": rows,
        "exact": exact, "ms": {v: spread(t) for v, t in times.items()},
        "overhead": overhead(times["abft"], times["unprotected"]),
        "analytic": analytic(d), "unprotected_bytes": ub,
        "extra_bytes": extra_bytes(), "extra_bytes_share": extra_bytes() / ub,
        "bound_ms": b_ms, "bound_by": b_by,
    }


def run(device="cuda", *, quick: bool = False, timer=None) -> List[dict]:
    """One row per (d, regular / weighted); ``quick`` shrinks the tables
    to 200,000 rows and d to 32 and 64, as the JAX benchmark's
    ``--quick`` does."""
    dev = resolve_device(device)
    timer = timer or make_timer(dev)
    rows = 200_000 if quick else ROWS
    dims = DIMS[:2] if quick else DIMS
    launches = LAUNCHES if dev.type == "cuda" else 2
    out = []
    for d in dims:
        enc = make_table(rows, d, dev)
        for weighted in (False, True):
            out.append(run_cell(enc, d, weighted, device=dev, timer=timer,
                                launches=launches))
        del enc
    return out


def table(rows: List[dict], clock: str = "device") -> str:
    def ms(s):
        return f"{s['median']:.5f} [{s['min']:.5f}–{s['max']:.5f}]"

    o = "overhead"
    body = [(
        r["d"], r["mode"], r["rows"], ms(r["ms"]["unprotected"]),
        ms(r["ms"]["abft"]),
        f"{pct(r[o]['median'])} [{pct(r[o]['min'])}, {pct(r[o]['max'])}]",
        pct(r["analytic"]),
        f"{r['extra_bytes']} ({pct(r['extra_bytes_share'])})",
        "yes" if r["exact"] else "NO") for r in rows]
    return markdown(
        f"Table I: ABFT EmbeddingBag overhead, batch {BATCH}, pooling "
        f"{POOL} ({clock} ms per call, median [min–max] of the rounds)",
        ["d", "mode", "rows", "unprotected", "abft", "overhead",
         "analytic", "extra bytes", "R exact"], body)


__all__ = ["run", "run_cell", "make_table", "table", "analytic",
           "unprotected_bytes", "extra_bytes", "ROWS", "DIMS", "POOL",
           "BATCH", "LAUNCHES"]
