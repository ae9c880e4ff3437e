"""``python -m repro_torch.campaign`` — run a main-path resilience campaign
on the card (or the CPU), or diff two campaign artifacts.

Examples::

    python -m repro_torch.campaign --quick                  # on the card
    python -m repro_torch.campaign --grid pallas --quick --device cpu
    python -m repro_torch.campaign --grid paper --seed 7 --out bench/
    python -m repro_torch.campaign --grid thresholds --device cpu --out t/
    python -m repro_torch.campaign --grid victims --samples 4
    python -m repro_torch.campaign --grid paging --quick    # paged KV
    python -m repro_torch.campaign --grid serving_soak --quick
    python -m repro_torch.campaign --grid serving_soak --quick \
        --plan "*:policy=recompute,kv_cache:on"             # every tenant
    python -m repro_torch.campaign --grid adaptive --quick  # threshold loop
    python -m repro_torch.campaign --grid training --quick  # train seams
    python -m repro_torch.campaign --grid multidevice --quick  # 4 ranks
    python -m repro_torch.campaign --diff OLD.json NEW.json # exit 1 on
                                                            # regression
    python -m repro_torch.campaign --trend                  # baseline history
    python -m repro_torch.campaign --trend BASE.json ... NEW.json
    python -m repro_torch.campaign --quick --monitor --obs-dir obs/

``--plan`` (a compact plan string, a JSON plan, or ``@path.json``)
replaces every tenant's plan of the ``serving_soak`` grid, unparsed, and
the paged lane's plan of the ``paging`` grid, as the JAX CLI does.
``--obs-dir`` exports the run's fault events (JSONL), Chrome trace and
Prometheus text; ``--monitor`` attaches the detection-health monitor.

``--grid multidevice`` (and ``full``, which holds its specs) runs its
sharded cells over a data mesh of ranks launched once for the run
(``--device-count N``; 4 when it is absent, as the JAX CLI forces 4 host
devices): ``gloo`` ranks on the CPU, and on the card one rank a device
or, with more ranks than cards, ``gloo`` ranks sharing them.  Rank 0
prints and writes the artifact.  Another grid has no sharded cell and
runs on one rank whatever ``--device-count`` says.  A grid that trains
(``training``, ``multidevice``) runs under
``torch.use_deterministic_algorithms``; the CLI sets
``CUBLAS_WORKSPACE_CONFIG`` before CUDA initialises.

    python -m repro_torch.campaign --grid multidevice --quick --device cpu
"""
from __future__ import annotations

import argparse
import os
import sys

def _grid_rank(world, grid: str, args) -> dict:
    """One rank of a sharded grid's world: the campaign, rank 0 printing
    and writing the artifact."""
    from repro_torch.campaign.artifacts import markdown_table
    from repro_torch.campaign.executor import CHUNK, run_campaign
    from repro_torch.campaign.grids import GRIDS
    kw = {"samples": args.samples} if grid == "multidevice" else {}
    if grid == "multidevice":
        kw["quick"] = args.quick
    specs = GRIDS[grid](seed=args.seed, **kw)
    name = f"{grid}_quick" if grid == "multidevice" and args.quick \
        else grid
    result = run_campaign(name, specs, device=world.device,
                          out_dir=args.out, chunk=args.chunk or CHUNK,
                          world=world,
                          verbose=lambda s: print(s, flush=True))
    if world.rank == 0:
        print()
        print(markdown_table(result))
        print(f"artifact: "
              f"{os.path.join(args.out, 'BENCH_campaign_' + name)}.json",
              flush=True)
    return result


def main(argv=None) -> int:
    # cuBLAS reads it when CUDA initialises; the training grid needs it
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    from repro_torch.campaign.grids import GRIDS, SHARDED_GRIDS

    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.campaign",
        description="Fault-injection sweeps of the main path (K1, K2 on "
                    "the card), JSON artifacts, and the artifact differ.")
    ap.add_argument("--quick", action="store_true",
                    help="shorthand for --grid quick; with --grid pallas, "
                         "paper or training, their quick variants")
    ap.add_argument("--grid", default=None,
                    help="quick, pallas, paper, thresholds, soak, "
                         "victims, training, multidevice, full, paging, "
                         "serving_soak or adaptive")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--samples", type=int, default=0,
                    help="override the per-cell sample count (quick / "
                         "pallas / thresholds / victims / training / "
                         "multidevice grids)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the cells run (default: the card; no "
                         "fallback)")
    ap.add_argument("--out", default=".",
                    help="artifact directory (default: cwd)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="trials per host synchronisation")
    ap.add_argument("--plan", default=None,
                    help="protection plan (compact string, JSON or "
                         "@path.json) for every serving_soak tenant and "
                         "the paging grid's paged lane")
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
    ap.add_argument("--trend", nargs="*", metavar="ARTIFACT", default=None,
                    help="fold artifacts (oldest..newest) into a per-cell "
                         "history table and gate the newest against the "
                         "prior median; with no paths, uses the committed "
                         "benchmarks/baselines/BENCH_campaign_*.json; "
                         "exits 1 on trend regressions")
    ap.add_argument("--trend-out", default=None,
                    help="--trend: also write the markdown history here")
    ap.add_argument("--latency-tol", type=float, default=None,
                    help="--trend: allowed overhead rise vs the prior "
                         "median (opt-in — wall-clock noise)")
    ap.add_argument("--obs-dir", default=None,
                    help="export observability artifacts (fault-event "
                         "JSONL, Chrome trace, Prometheus text) for the "
                         "run into this directory")
    ap.add_argument("--obs-flush-every", type=int, default=0, metavar="N",
                    help="crash-durable obs: append events to the JSONL "
                         "as they happen and rewrite metric/trace "
                         "snapshots every N events (needs --obs-dir)")
    ap.add_argument("--monitor", action="store_true",
                    help="attach the live detection-health monitor to "
                         "the obs bus (windowed alert rules + per-scope "
                         "health states; summary printed at the end)")
    ap.add_argument("--device-count", type=int, default=0,
                    help="ranks of the data mesh the sharded cells run "
                         "over (multidevice, full; 4 when absent)")
    args = ap.parse_args(argv)

    if args.diff:
        from repro_torch.campaign.diff import run_diff
        return run_diff(args.diff[0], args.diff[1], det_tol=args.det_tol,
                        fp_tol=args.fp_tol,
                        overhead_tol=args.overhead_tol,
                        out_path=args.diff_out)
    if args.trend is not None:
        from repro_torch.campaign.trend import run_trend
        return run_trend(args.trend, det_tol=args.det_tol,
                         fp_tol=args.fp_tol, latency_tol=args.latency_tol,
                         out_path=args.trend_out)

    grid = args.grid or ("quick" if args.quick else None)
    if grid is None:
        ap.error("pick a grid (--quick / --grid "
                 "{quick,pallas,paper,thresholds,soak,victims,training,"
                 "multidevice,full,paging,serving_soak,adaptive}) or "
                 "--diff OLD NEW")
    if args.device_count < 0:
        ap.error(f"--device-count {args.device_count}: at least 1 rank")
    engines = ("paging", "serving_soak", "adaptive")
    if grid not in engines and grid not in GRIDS:
        ap.error(f"unknown grid {grid!r} ({', '.join(GRIDS)}, "
                 f"{', '.join(engines)})")
    if args.plan is not None and grid not in ("paging", "serving_soak"):
        ap.error("--plan applies to the serving_soak and paging grids")

    obs = None
    if args.obs_dir or args.monitor:
        from repro_torch.obs import Observability
        obs = Observability.create()
        if args.obs_dir and args.obs_flush_every > 0:
            obs.open_incremental(args.obs_dir, every=args.obs_flush_every)
    monitor = None
    if args.monitor:
        from repro_torch.obs import Monitor
        monitor = Monitor()

    if grid in SHARDED_GRIDS:
        # the world is launched once for the whole run
        from repro_torch.campaign.executor import resolve_device_count
        from repro_torch.device import resolve_device
        from repro_torch.sharding import launch
        if obs is not None:
            ap.error(f"--obs-dir / --monitor do not apply to --grid {grid} "
                     f"(its cells run in a world of ranks)")
        if not args.device_count:
            args.device_count = 4
            print(f"[{grid}] launching 4 ranks for the sharded cells (pass "
                  f"--device-count to override)", flush=True)
        dev = resolve_device(args.device)
        n = resolve_device_count(args.device_count, dev)
        launch(_grid_rank, n, args=(grid, args), device=dev)
        return 0
    if args.device_count > 1:
        print(f"[{grid}] no cell of this grid shards: it runs on one rank "
              f"(--device-count {args.device_count})", flush=True)

    from repro_torch.campaign.artifacts import markdown_table
    if grid == "serving_soak":
        # live-traffic soak: the serving engine, not the trial executor
        import dataclasses

        from repro_torch.serving.soak import (full_soak_spec,
                                              quick_soak_spec,
                                              run_soak_campaign)
        spec = None
        if args.plan is not None:
            spec = quick_soak_spec(args.seed) if args.quick \
                else full_soak_spec(args.seed)
            spec = dataclasses.replace(spec, tenants=tuple(
                (n, w, args.plan) for n, w, _ in spec.tenants))
        result = run_soak_campaign(spec, quick=args.quick, seed=args.seed,
                                   out_dir=args.out, device=args.device,
                                   obs=obs, monitor=monitor,
                                   verbose=lambda s: print(s, flush=True))
        print()
        print(markdown_table(result))
        print(f"artifact: "
              f"{os.path.join(args.out, 'BENCH_campaign_serving_soak')}"
              f".json")
        _print_monitor(monitor)
        _write_obs(obs, args.obs_dir)
        return 0
    if grid == "adaptive":
        # controller-convergence cells (repro_torch.campaign.adaptive)
        from repro_torch.campaign.adaptive import run_adaptive_campaign
        result = run_adaptive_campaign(
            quick=args.quick, seed=args.seed, out_dir=args.out, obs=obs,
            device=args.device, verbose=lambda s: print(s, flush=True))
        print()
        print(markdown_table(result))
        name = "adaptive_quick" if args.quick else "adaptive"
        print(f"artifact: "
              f"{os.path.join(args.out, 'BENCH_campaign_' + name)}.json")
        _write_obs(obs, args.obs_dir)
        return 0
    if grid == "paging":
        # paged-KV parity + repair cells (repro_torch.serving.paging_soak)
        from repro_torch.serving.paging_soak import run_paging_campaign
        result = run_paging_campaign(quick=args.quick, seed=args.seed,
                                     plan=args.plan, out_dir=args.out,
                                     device=args.device, obs=obs,
                                     verbose=lambda s: print(s, flush=True))
        print()
        print(markdown_table(result))
        name = "paging_quick" if args.quick else "paging"
        print(f"artifact: "
              f"{os.path.join(args.out, 'BENCH_campaign_' + name)}.json")
        _write_obs(obs, args.obs_dir)
        return 0

    from repro_torch.campaign.artifacts import (breakdown_markdown,
                                                threshold_curve_markdown)
    from repro_torch.campaign.executor import CHUNK, run_campaign

    if grid == "quick":
        specs = GRIDS[grid](seed=args.seed, samples=args.samples or 600)
    elif grid == "paper":
        specs = GRIDS[grid](seed=args.seed, quick=args.quick)
    elif grid == "thresholds":
        specs = GRIDS[grid](seed=args.seed, samples=args.samples or 400)
    elif grid == "victims":
        specs = GRIDS[grid](seed=args.seed, samples=args.samples or 12)
    elif grid == "soak":
        specs = GRIDS[grid](seed=args.seed)
    else:
        specs = GRIDS[grid](seed=args.seed, quick=args.quick,
                            samples=args.samples)
    name = f"{grid}_quick" if grid in ("pallas", "training") \
        and args.quick else grid
    result = run_campaign(name, specs, device=args.device, out_dir=args.out,
                          chunk=args.chunk or CHUNK, obs=obs,
                          monitor=monitor,
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
    _print_monitor(monitor)
    _write_obs(obs, args.obs_dir)
    return 0


def _print_monitor(monitor) -> None:
    if monitor is None:
        return
    ms = monitor.summary()
    print(f"monitor: {ms['ticks']} tick(s), {ms['alerts_fired']} "
          f"alert(s), health {ms['health'] or '{}'}")
    for a in ms["alerts"]:
        print(f"  alert {a['rule']} [{a['severity']}] {a['scope']}: "
              f"{a['metric']}={a['value']:.4g} vs {a['threshold']:.4g}")


def _write_obs(obs, obs_dir) -> None:
    if obs is None or obs_dir is None:
        return
    for kind, path in sorted(obs.write(obs_dir).items()):
        print(f"obs {kind}: {path}")


if __name__ == "__main__":
    sys.exit(main())
