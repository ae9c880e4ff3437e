"""``python -m repro_torch.benchmarks.run`` — the paper's overhead
benchmarks on the card (or, with ``--device cpu``, the plain versions on
the CPU, to exercise the arithmetic only).

Examples::

    python -m repro_torch.benchmarks.run            # Fig. 5, Table I, rooflines
    python -m repro_torch.benchmarks.run --only eb_overhead --out bench/
    python -m repro_torch.benchmarks.run --quick --device cpu

Prints each table in markdown and, with ``--out``, writes every figure
to ``BENCH_overhead.json`` there, beside the device it ran on.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

BENCHES = ("gemm_overhead", "eb_overhead", "roofline_table")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.benchmarks.run",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="every fourth GEMM shape; 200,000-row tables at "
                         "d 32 and 64")
    ap.add_argument("--only", choices=BENCHES, default=None,
                    help="run one benchmark")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the programs run (default: the card; no "
                         "fallback)")
    ap.add_argument("--out", default=None,
                    help="also write BENCH_overhead.json here")
    args = ap.parse_args(argv)

    from repro_torch.benchmarks import (common, eb_overhead, gemm_overhead,
                                        roofline_table)
    from repro_torch.device import resolve_device

    dev = resolve_device(args.device)
    timer = common.make_timer(dev)
    result = {"device": common.device_info(dev), "rounds": common.ROUNDS}
    mods = {"gemm_overhead": gemm_overhead, "eb_overhead": eb_overhead,
            "roofline_table": roofline_table}
    for name in ([args.only] if args.only else BENCHES):
        mod = mods[name]
        t0 = time.perf_counter()
        rows = mod.run(dev, quick=args.quick, timer=timer)
        print(mod.table(rows, timer.clock), flush=True)
        print(f"({name}: {time.perf_counter() - t0:.1f}s)", flush=True)
        result[name] = rows
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "BENCH_overhead.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=2, default=str)
            f.write("\n")
        print(f"figures: {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
