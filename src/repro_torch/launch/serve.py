"""Serving driver of the port: a thin CLI over
:class:`repro_torch.serving.ServingEngine`.

``python -m repro_torch.launch.serve --arch dlrm`` serves the full-width
DLRM (26 tables x 4M rows x 128) on the card; ``--device cpu --smoke``
serves a small one on the CPU through the plain PyTorch versions.  A
seeded request stream (Poisson / bursty / trace arrivals) flows through
the admission queue into per-tenant plan lanes; telemetry reports
per-tenant latency percentiles next to the ABFT fault counters::

    --plan "*:policy=recompute"                  # retry on detection
    --tenant "premium:2=*:policy=recompute" \
    --tenant "batch=*:policy=log,embedding_bag:off"

The JAX driver's flags for parts not ported yet are rejected with the
ROADMAP item that ports them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

#: flags of the JAX driver whose subsystems wait for later slices
_NOT_PORTED = {
    "--prompt-len": "A8 (LM decode and serving)",
    "--decode-tokens": "A8 (LM decode and serving)",
    "--paged-kv": "A8 (paged KV cache)",
    "--kv-pages": "A8 (paged KV cache)",
    "--inject-step": "A2 (fault injection)",
    "--inject-victim": "A2 (fault injection)",
    "--inject-persistent": "A2 (fault injection)",
    "--obs-dir": "A9 (observability)",
    "--obs-flush-every": "A9 (observability)",
    "--monitor": "A9 (health monitor)",
    "--adaptive": "A9 (adaptive thresholds)",
    "--fp-budget": "A9 (adaptive thresholds)",
    "--calibrate-from": "A9 (adaptive thresholds)",
    "--device-count": "A12 (sharding and launch)",
}


class _NotPorted(argparse.Action):
    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (ROADMAP "
                     f"{_NOT_PORTED[option_string]})")


def parse_tenant(arg: str):
    """``NAME[:WEIGHT]=PLAN`` -> (name, weight, plan_text)."""
    head, _, plan_text = arg.partition("=")
    if not plan_text:
        raise ValueError(f"--tenant {arg!r}: expected NAME[:WEIGHT]=PLAN")
    name, _, w = head.partition(":")
    if not name:
        raise ValueError(f"--tenant {arg!r}: empty tenant name")
    try:
        weight = float(w) if w else 1.0
    except ValueError:
        raise ValueError(f"--tenant {arg!r}: bad weight {w!r} "
                         f"(expected NAME[:WEIGHT]=PLAN)") from None
    return name, weight, plan_text


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.launch.serve",
        description="Protected DLRM serving over a synthetic request "
                    "stream, on the card (or the CPU).")
    ap.add_argument("--arch", default="dlrm")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to serve (default: the card; no fallback)")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4,
                    help="admission slots per lane")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty", "trace"])
    ap.add_argument("--rate", type=float, default=100.0,
                    help="arrival rate (requests/s of virtual time)")
    ap.add_argument("--trace", default=None,
                    help="JSON file with arrival offsets (--arrival trace)")
    ap.add_argument("--queue-depth", type=int, default=0,
                    help="admission queue bound (0 = unbounded)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced model + small stream")
    ap.add_argument("--plan", default=None,
                    help="single-tenant protection plan: compact string "
                         "('*:policy=recompute,embedding_bag:off') or "
                         "@path.json holding a plan dict")
    ap.add_argument("--tenant", action="append", default=[],
                    metavar="NAME[:WEIGHT]=PLAN",
                    help="add a traffic class with its own plan "
                         "(repeatable; replaces --plan)")
    ap.add_argument("--no-abft", action="store_true",
                    help="unprotected baseline (= --plan '*:off')")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="write the full telemetry timeline here")
    for flag in _NOT_PORTED:
        ap.add_argument(flag, nargs="?", action=_NotPorted,
                        help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    from repro_torch.configs.registry import get_arch
    from repro_torch.protect import (ProtectionPlan, default_plan,
                                     unprotected_plan)
    from repro_torch.serving import (ServingEngine, TenantSpec, dlrm_stream,
                                     tenant_weights)

    logging.basicConfig(level=logging.INFO, format="%(message)s")
    log = logging.getLogger("repro_torch.serve")

    if args.no_abft and (args.plan is not None or args.tenant):
        ap.error("--no-abft conflicts with --plan/--tenant; start the "
                 "plan from '*:off' instead")
    if args.arrival == "trace" and not args.trace:
        ap.error("--arrival trace needs --trace FILE")
    try:
        cfg = get_arch(args.arch)
    except (KeyError, NotImplementedError) as e:
        ap.error(str(e))

    if args.tenant:
        tenants = []
        for t in args.tenant:
            try:
                name, weight, plan_text = parse_tenant(t)
                plan = default_plan().with_rules(
                    *ProtectionPlan.from_any(plan_text).rules)
            except ValueError as e:
                ap.error(str(e))
            tenants.append(TenantSpec(
                name, dataclasses.replace(plan, name=name), weight))
    else:
        if args.plan is not None:
            plan = default_plan().with_rules(
                *ProtectionPlan.from_any(args.plan).rules)
        elif args.no_abft:
            plan = unprotected_plan()
        else:
            plan = default_plan()
        tenants = [TenantSpec("default", plan)]
    for t in tenants:
        log.info("tenant %-10s (weight %g): %s", t.name, t.weight,
                 t.resolved_plan().describe())

    dlrm_extras = None
    if args.smoke:
        from repro_torch.configs.dlrm import EXTRAS
        args.requests = min(args.requests, 12)
        dlrm_extras = dataclasses.replace(
            EXTRAS, table_rows=512, n_tables=4, emb_dim=32,
            bottom_mlp=(64, 32), top_mlp=(64, 32, 1))

    engine = ServingEngine(cfg, tenants, n_slots=args.slots,
                           queue_depth=args.queue_depth, seed=args.seed,
                           dlrm_extras=dlrm_extras, device=args.device)
    trace = None
    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
    ex = engine.dlrm_extras
    stream = dlrm_stream(
        args.requests, tenants=tenant_weights(tenants), rate_rps=args.rate,
        arrival=args.arrival, seed=args.seed,
        lookup_batch=min(ex.batch, 10), table_rows=ex.table_rows,
        n_tables=ex.n_tables, trace=trace)

    log.info("serving %d dlrm requests (%s arrivals @ %g rps) on %s, "
             "%d lane(s)...", args.requests, args.arrival, args.rate,
             engine.device, len(engine.lanes))
    telemetry = engine.run(stream)
    s = telemetry.summary()

    log.info("")
    log.info("%d requests / %d steps in %.3fs of traffic, queue depth "
             "max %d", s["requests"], s["steps"], s["span_s"],
             s["queue_depth_max"])
    for tname, ts in s["per_tenant"].items():
        log.info("  %-10s n=%-4d done=%-4d abort=%-3d "
                 "e2e p50/p95/p99 = %.3f/%.3f/%.3f ms", tname,
                 ts["requests"], ts["completed"], ts["aborted"],
                 ts["e2e_ms"]["p50"], ts["e2e_ms"]["p95"],
                 ts["e2e_ms"]["p99"])
    nz = {k: v for k, v in s["faults"]["counters"].items() if v}
    log.info("fault counters: %s", nz or "all zero")
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump(telemetry.to_dict(), fp, indent=2)
        log.info("telemetry written to %s", args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
