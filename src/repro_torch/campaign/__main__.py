"""``python -m repro_torch.campaign`` — run a main-path resilience campaign
on the card (or the CPU), or diff two campaign artifacts.

Examples::

    python -m repro_torch.campaign --quick                  # on the card
    python -m repro_torch.campaign --grid pallas --quick --device cpu
    python -m repro_torch.campaign --grid paper --seed 7 --out bench/
    python -m repro_torch.campaign --grid thresholds --device cpu --out t/
    python -m repro_torch.campaign --diff OLD.json NEW.json # exit 1 on
                                                            # regression

The JAX package's other grids and flags exit with 2, naming the ROADMAP
item that ports them.
"""
from __future__ import annotations

import argparse
import os
import sys

#: flags of the JAX campaign CLI whose subsystems wait for later slices
_NOT_PORTED = {
    "--plan": "A4 (serving grids)",
    "--device-count": "A8 (sharding and launch)",
    "--trend": "A5 (observability)",
    "--obs-dir": "A5 (observability)",
    "--obs-flush-every": "A5 (observability)",
    "--monitor": "A5 (health monitor)",
}


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (ROADMAP "
                     f"{_NOT_PORTED[option_string]})")


def main(argv=None) -> int:
    from repro_torch.campaign.grids import GRIDS, NOT_PORTED

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.campaign",
        description="Fault-injection sweeps of the main path (K1, K2 on "
                    "the card), JSON artifacts, and the artifact differ.")
    ap.add_argument("--quick", action="store_true",
                    help="shorthand for --grid quick; with --grid pallas "
                         "or paper, their quick variants")
    ap.add_argument("--grid", default=None,
                    help="quick, pallas, paper or thresholds")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=0,
                    help="override the per-cell sample count (quick / "
                         "pallas / thresholds grids)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the cells run (default: the card; no "
                         "fallback)")
    ap.add_argument("--out", default=".",
                    help="artifact directory (default: cwd)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="trials per host synchronisation")
    ap.add_argument("--diff", nargs=2, metavar=("OLD", "NEW"),
                    help="diff two BENCH_campaign_*.json artifacts and "
                         "exit 1 on detection/FP regressions")
    ap.add_argument("--det-tol", type=float, default=0.02,
                    help="--diff: allowed detection-rate drop")
    ap.add_argument("--fp-tol", type=float, default=0.02,
                    help="--diff: allowed false-positive-rate rise")
    ap.add_argument("--overhead-tol", type=float, default=None,
                    help="--diff: allowed overhead rise (opt-in)")
    ap.add_argument("--diff-out", default=None,
                    help="--diff: also write the markdown report here")
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="*", action=_NotPorted,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    if args.diff:
        from repro_torch.campaign.diff import run_diff
        return run_diff(args.diff[0], args.diff[1], det_tol=args.det_tol,
                        fp_tol=args.fp_tol,
                        overhead_tol=args.overhead_tol,
                        out_path=args.diff_out)

    grid = args.grid or ("quick" if args.quick else None)
    if grid is None:
        ap.error("pick a grid (--quick / --grid "
                 "{quick,pallas,paper,thresholds}) or --diff OLD NEW")
    if grid in NOT_PORTED:
        ap.error(f"--grid {grid} is not ported yet (ROADMAP "
                 f"{NOT_PORTED[grid]})")
    if grid not in GRIDS:
        ap.error(f"unknown grid {grid!r} ({', '.join(GRIDS)})")

    from repro_torch.campaign.artifacts import (breakdown_markdown,
                                                markdown_table,
                                                threshold_curve_markdown)
    from repro_torch.campaign.executor import CHUNK, run_campaign

    if grid == "quick":
        specs = GRIDS[grid](seed=args.seed, samples=args.samples or 600)
    elif grid == "paper":
        specs = GRIDS[grid](seed=args.seed, quick=args.quick)
    elif grid == "thresholds":
        specs = GRIDS[grid](seed=args.seed, samples=args.samples or 400)
    else:
        specs = GRIDS[grid](seed=args.seed, quick=args.quick,
                            samples=args.samples)
    name = "pallas_quick" if grid == "pallas" and args.quick else grid
    result = run_campaign(name, specs, device=args.device, out_dir=args.out,
                          chunk=args.chunk or CHUNK,
                          verbose=lambda s: print(s, flush=True))
    print()
    print(markdown_table(result))
    if grid == "thresholds":
        print(threshold_curve_markdown(result))
    bd = breakdown_markdown(result)
    if bd:
        print(bd)
    print(f"artifact: {os.path.join(args.out, 'BENCH_campaign_' + name)}"
          f".json")
    return 0


if __name__ == "__main__":
    sys.exit(main())
