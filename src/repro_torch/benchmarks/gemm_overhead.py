"""Fig. 5 on the card: the ABFT int8 GEMM's overhead over the 28 DLRM
shapes (the JAX package's ``benchmarks/gemm_overhead.py``).

Three programs per (m, n, k), A uint8 and B int8 as the JAX benchmark
draws them:

* ``unprotected`` — K1's unprotected instance: ``A @ B'[:, :n]`` from the
  same packed operand, through the same mainloop and plan, without the
  checksum column, the mod-127 epilogue and the scratch (the counterpart
  of the JAX benchmark's plain ``dot_general``);
* ``abft`` — K1 on the pre-packed B' (encoding amortized: the paper's
  serving configuration);
* ``abft+encode`` — ``pack_encoded_b`` and K1, the encoding on the
  critical path.

Each is timed by CUDA events over back-to-back launches, in alternating
rounds (:func:`~repro_torch.benchmarks.common.alternate`), cold (every
launch takes the next of enough distinct copies of the weight that they
exceed the 50 MB L2, where the count allows) and warm (one copy).  The
overhead of a round is ``protected / unprotected - 1``; a cell reports
the median of the rounds and their spread.  Beside them: the paper's
analytic ``1/(2m) + 1/n + 1/(2k)`` (§IV-A1); the bytes the protected
program must move over the unprotected one, from the shapes (the
checksum column of B', k bytes, and the err vector, 4m); the MMA column
tiles of the two plans (the checksum column is a tile of its own where n
is a multiple of 128); and ``torch._int_mm`` on s8 operands padded to
its shape limits, as information only.  Every cell also holds the
unprotected C bit-exact to the protected kernel's.
"""
from __future__ import annotations

import itertools
import math
from typing import List, Optional

import torch

from repro_torch.benchmarks.common import (GEMM_SHAPES, INT8_OPS_PER_S,
                                           L2_BYTES, alternate,
                                           bound_ms, make_timer, markdown,
                                           overhead, pct, spread)
from repro_torch.core import LANE, pack_encoded_b
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.kernels.abft_qgemm import launch_plan

#: launches per timing on the card (well inside the launch queue), and
#: the most weight copies a cold cell cycles through
LAUNCHES = 100
MAX_COPIES = 400


def unprotected_bytes(m: int, n: int, k: int) -> int:
    """A, B and C, each once: what the unprotected program must move."""
    return m * k + k * n + 4 * m * n


def extra_bytes(m: int, n: int, k: int) -> int:
    """What the protected program must move beyond that: B''s checksum
    column (k bytes) and the err vector (4m)."""
    return k + 4 * m


def analytic(m: int, n: int, k: int) -> float:
    """The paper's §IV-A1 overhead model."""
    return 1 / (2 * m) + 1 / n + 1 / (2 * k)


def int_mm_shape(m: int, n: int, k: int) -> tuple:
    """(m, n, k) padded to what ``torch._int_mm`` takes on the card: m to
    a multiple of 32 (it refused 24 and 104 rows at k 16), k and n to
    multiples of 8."""
    return -(-m // 32) * 32, -(-n // 8) * 8, -(-k // 8) * 8


def operands(m: int, n: int, k: int, device) -> tuple:
    """A shape's operands, from seed m·n·k: A uint8 [m, k], B int8 [k, n]
    in [-127, 127] (as the JAX benchmark draws them) and B' packed."""
    gen = torch.Generator().manual_seed(m * n * k)
    a = torch.randint(0, 256, (m, k), dtype=torch.uint8,
                      generator=gen).to(device)
    b = torch.randint(-127, 128, (k, n), dtype=torch.int8,
                      generator=gen).to(device)
    return a, b, pack_encoded_b(b)


def int_mm_operands(a: torch.Tensor, b_packed: torch.Tensor) -> tuple:
    """``torch._int_mm``'s s8 operands for the shape of ``a @ B``: B's
    values and a zero A (uint8 A has no s8 form: the yardstick computes
    another product on the same shape), padded by :func:`int_mm_shape`."""
    m, k = a.shape
    n = b_packed.shape[1] - LANE
    mp, np_, kp = int_mm_shape(m, n, k)
    ap = torch.zeros((mp, kp), dtype=torch.int8, device=a.device)
    bq = torch.zeros((kp, np_), dtype=torch.int8, device=a.device)
    bq[:k, :n] = b_packed[:, :n]
    return ap, bq


def _library(timer, a, b_packed, launches) -> Optional[float]:
    """``torch._int_mm`` on :func:`int_mm_operands`: a yardstick only,
    None where it refuses the shape."""
    ap, bq = int_mm_operands(a, b_packed)
    try:
        return timer.ms(lambda: torch._int_mm(ap, bq), launches)
    except RuntimeError:
        return None


def run_shape(m: int, n: int, k: int, *, device, timer,
              launches: int) -> dict:
    dev = device
    on_card = dev.type == "cuda"
    a, b, packed = operands(m, n, k, dev)
    c_un = kops.qgemm_unprotected(a, packed)
    c, err = kops.abft_qgemm(a, packed)
    exact = bool(torch.equal(c_un, c)) and not bool(err.any())

    nbytes = k * (n + LANE)
    copies = (max(2, min(MAX_COPIES, math.ceil(2 * L2_BYTES / nbytes)))
              if on_card else 1)
    packs = [packed] + [packed.clone() for _ in range(copies - 1)]
    raws = [b] + [b.clone() for _ in range(copies - 1)]
    nxt = itertools.cycle(range(copies)).__next__   # one cycle for all
    cold = alternate(timer, {
        "unprotected": lambda: kops.qgemm_unprotected(a, packs[nxt()]),
        "abft": lambda: kops.abft_qgemm(a, packs[nxt()]),
        "abft+encode": lambda: kops.abft_qgemm(
            a, pack_encoded_b(raws[nxt()])),
    }, launches)
    warm = alternate(timer, {
        "unprotected": lambda: kops.qgemm_unprotected(a, packed),
        "abft": lambda: kops.abft_qgemm(a, packed),
    }, launches)
    del packs, raws
    tiles = {p: launch_plan(m, k, n, protect=p).tiles_n
             for p in (True, False)}
    ub = unprotected_bytes(m, n, k)
    b_ms, b_by = bound_ms(ub, 2 * m * n * k, INT8_OPS_PER_S)
    return {
        "shape": (m, n, k), "exact": exact, "copies": copies,
        "cycle_mb": copies * nbytes / 2**20,
        "cold_in_hbm": copies * nbytes > L2_BYTES,
        "cold_ms": {v: spread(t) for v, t in cold.items()},
        "warm_ms": {v: spread(t) for v, t in warm.items()},
        "overhead_cold": overhead(cold["abft"], cold["unprotected"]),
        "overhead_encode": overhead(cold["abft+encode"],
                                    cold["unprotected"]),
        "overhead_warm": overhead(warm["abft"], warm["unprotected"]),
        "analytic": analytic(m, n, k),
        "unprotected_bytes": ub, "extra_bytes": extra_bytes(m, n, k),
        "extra_bytes_share": extra_bytes(m, n, k) / ub,
        "mma_tiles": tiles,
        "checksum_tile_share": tiles[True] / tiles[False] - 1,
        "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": (_library(timer, a, packed, launches)
                       if on_card else None),
    }


def run(device="cuda", *, quick: bool = False, timer=None) -> List[dict]:
    """One row per Fig. 5 shape: the 28 of them, every fourth with
    ``quick``."""
    dev = resolve_device(device)
    timer = timer or make_timer(dev)
    shapes = GEMM_SHAPES[::4] if quick else GEMM_SHAPES
    launches = LAUNCHES if dev.type == "cuda" else 2
    return [run_shape(m, n, k, device=dev, timer=timer, launches=launches)
            for m, n, k in shapes]


def table(rows: List[dict], clock: str = "device") -> str:
    def ms(s):
        return (f"{s['median']:.4f} [{s['min']:.4f}–{s['max']:.4f}]")

    def ov(s):
        return f"{pct(s['median'])} [{pct(s['min'])}, {pct(s['max'])}]"

    body = [(
        "×".join(map(str, r["shape"])),
        ms(r["cold_ms"]["unprotected"]), ms(r["cold_ms"]["abft"]),
        ms(r["cold_ms"]["abft+encode"]), ov(r["overhead_cold"]),
        pct(r["overhead_encode"]["median"]),
        ms(r["warm_ms"]["unprotected"]), ms(r["warm_ms"]["abft"]),
        ov(r["overhead_warm"]), pct(r["analytic"]),
        f"{r['extra_bytes']} ({pct(r['extra_bytes_share'])})",
        f"{r['mma_tiles'][True]}/{r['mma_tiles'][False]}",
        f"{r['cycle_mb']:.1f}" + ("" if r["cold_in_hbm"] else " (L2)"),
        "—" if r["library_ms"] is None else f"{r['library_ms']:.4f}",
        "yes" if r["exact"] else "NO") for r in rows]
    return markdown(
        f"Fig. 5: ABFT int8 GEMM overhead ({clock} ms per call, median "
        f"[min–max] of the rounds)",
        ["m×n×k", "unprot cold", "abft cold", "abft+encode cold",
         "overhead cold", "ovh +encode", "unprot warm", "abft warm",
         "overhead warm", "analytic", "extra bytes", "MMA tiles p/u",
         "cycle MB", "_int_mm", "C exact"], body)


__all__ = ["run", "run_shape", "table", "analytic", "unprotected_bytes",
           "extra_bytes", "operands", "int_mm_shape", "int_mm_operands",
           "LAUNCHES", "MAX_COPIES"]
