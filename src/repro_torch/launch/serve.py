"""Serving driver of the port: a thin CLI over
:class:`repro_torch.serving.ServingEngine`.

``python -m repro_torch.launch.serve --arch dlrm`` serves the full-width
DLRM (26 tables x 4M rows x 128) on the card; ``--arch llama3.2-1b`` (or
another registered dense LM: ``qwen3-8b``, ``internlm2-20b``), ``--arch
granite-moe-3b-a800m`` (the MoE), ``--arch rwkv6-1.6b``, ``--arch
whisper-large-v3`` (encoder-decoder, stub frames), ``--arch hymba-1.5b``
(attention beside Mamba heads, meta tokens) and ``--arch
llava-next-mistral-7b`` (stub patches through the projector) serve the
full-width int8 model (chat requests: prefill, then continuous batched
decode over ``--slots``; up to ``--decode-tokens`` new tokens each);
``--device cpu --smoke`` serves a small model on the CPU through the
plain PyTorch versions.  A seeded
request stream (Poisson / bursty / trace arrivals) flows through the
admission queue into per-tenant plan lanes; telemetry reports
per-tenant latency percentiles next to the ABFT fault counters::

    --plan "*:policy=recompute"                  # retry on detection
    --plan "*:policy=recompute,kv_cache:on"      # + the checksummed int8
                                                 #   KV cache
    --paged-kv 16 --kv-pages 256 \
    --plan "*:policy=recompute,kv_cache_paged:on"  # the paged, prefix-shared,
                                                   # page-checksummed cache
    --tenant "premium:2=*:policy=recompute" \
    --tenant "batch=*:policy=log,embedding_bag:off"
    --inject-step 7 --inject-victim attn.wq      # transient flip at step 7
    --inject-step 7 --inject-persistent          # ... left in place
    --monitor --obs-dir obs/                     # alerts, tenant health,
                                                 #   quarantine; events,
                                                 #   trace, Prometheus text
    --adaptive --fp-budget 0.01 \
    --plan "*:policy=log,embedding_bag:threshold=adaptive"
                                                 # FP-budget rel_bound loop

``--inject-step`` restores the clean weight right after the faulty step
(unless ``--inject-persistent``), and the log says whether and when the
flip was flagged.  As in the JAX CLI, a KV-cache flip is reached through
the engine's API (``FaultInjection(target="kv")``) only.
``--device-count N`` asks for N devices, as the JAX CLI forces N host
devices: the port checks that N exist (any N on ``--device cpu``, else
``torch.cuda.device_count()``; fewer exit with 2) and, as JAX does,
serves on the first.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import os
import sys

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
        description="Protected DLRM or LM serving over a synthetic "
                    "request stream, on the card (or the CPU).")
    ap.add_argument("--arch", default="dlrm")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where to serve (default: the card; no fallback)")
    ap.add_argument("--slots", "--batch", dest="slots", type=int, default=4,
                    help="admission slots per lane (the decode batch)")
    ap.add_argument("--prompt-len", type=int, default=64,
                    help="prompt bucket (prompts pad up to this)")
    ap.add_argument("--decode-tokens", type=int, default=32,
                    help="max new tokens per request")
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
    ap.add_argument("--paged-kv", type=int, default=0, metavar="PAGE_SIZE",
                    help="serve from the paged, prefix-shared, "
                         "per-page-checksummed KV cache with this page "
                         "size (pair with a kv_cache_paged:on plan)")
    ap.add_argument("--kv-pages", type=int, default=256,
                    help="page-pool size per lane (--paged-kv)")
    ap.add_argument("--no-abft", action="store_true",
                    help="unprotected baseline (= --plan '*:off')")
    ap.add_argument("--inject-step", type=int, action="append",
                    default=None, metavar="STEP",
                    help="flip a weight bit before this engine step "
                         "(repeatable — a burst of transient faults)")
    ap.add_argument("--inject-victim", default=None,
                    help="victim leaf-path pattern (e.g. 'attn.wq', "
                         "'cm.wv', 'top.0'); default: largest int8 leaf")
    ap.add_argument("--inject-persistent", action="store_true",
                    help="leave the flipped bit in place (default: "
                         "restore the clean weight after the step)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--json", default=None,
                    help="write the full telemetry timeline here")
    ap.add_argument("--obs-dir", default=None,
                    help="export observability artifacts (fault-event "
                         "JSONL, Chrome trace, Prometheus text) here")
    ap.add_argument("--obs-flush-every", type=int, default=0,
                    metavar="N",
                    help="crash-durable obs: append each event to the "
                         "JSONL as it happens and rewrite the metrics/"
                         "trace snapshots every N events (needs "
                         "--obs-dir)")
    ap.add_argument("--monitor", action="store_true",
                    help="attach the live detection-health monitor: "
                         "windowed alert rules over the obs bus drive "
                         "healthy/degraded/quarantined tenant states "
                         "with real engine responses (admission "
                         "quarantine, plan escalation, paged-KV scrub)")
    ap.add_argument("--adaptive", action="store_true",
                    help="close the threshold loop: ops whose plan says "
                         "threshold=adaptive get a per-(op, tenant) "
                         "FP-budget controller over rel_bound, fed by "
                         "the monitor's Wilson flag-rate estimates "
                         "(implies --monitor)")
    ap.add_argument("--fp-budget", type=float, default=0.01,
                    help="--adaptive: tolerated false-positive rate the "
                         "controllers hold")
    ap.add_argument("--calibrate-from", default=None, metavar="ARTIFACT",
                    help="--adaptive: seed initial bounds from a "
                         "committed --grid thresholds sweep artifact "
                         "instead of the ops' static defaults")
    ap.add_argument("--device-count", type=int, default=0,
                    help="devices the run asks for (it serves on the "
                         "first, as the JAX CLI does)")
    args = ap.parse_args(argv)
    if args.device_count:
        import torch
        have = (args.device_count if args.device == "cpu"
                else torch.cuda.device_count())
        if args.device_count < 1 or args.device_count > have:
            ap.error(f"--device-count {args.device_count}: {have} "
                     f"{args.device} device(s) here (ROADMAP A8.1: the "
                     f"port serves on the first of the devices it asks "
                     f"for, which must exist)")

    from repro_torch.configs.registry import get_arch
    from repro_torch.protect import (ProtectionPlan, default_plan,
                                     unprotected_plan)
    from repro_torch.serving import (FaultInjection, ServingEngine,
                                     TenantSpec, chat_stream, dlrm_stream,
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
    except KeyError as e:
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
        from repro_torch.configs import reduce_cfg
        cfg = reduce_cfg(cfg)
        args.requests = min(args.requests, 12)
        args.prompt_len = min(args.prompt_len, 32)
        args.decode_tokens = min(args.decode_tokens, 8)
        if cfg.family == "dlrm":
            from repro_torch.configs.dlrm import EXTRAS
            dlrm_extras = dataclasses.replace(
                EXTRAS, table_rows=512, n_tables=4, emb_dim=32,
                bottom_mlp=(64, 32), top_mlp=(64, 32, 1))

    if args.paged_kv < 0:
        ap.error("--paged-kv takes a positive page size (0: no paging)")
    paging = None
    if args.paged_kv:
        from repro_torch.paging import PagingConfig
        paging = PagingConfig(page_size=args.paged_kv,
                              n_pages=args.kv_pages)
    try:
        engine = ServingEngine(cfg, tenants, n_slots=args.slots,
                               max_prompt=args.prompt_len,
                               max_new_tokens=args.decode_tokens,
                               queue_depth=args.queue_depth, seed=args.seed,
                               dlrm_extras=dlrm_extras, paging=paging,
                               device=args.device)
    except ValueError as e:             # e.g. duplicate tenant names
        ap.error(str(e))
    trace = None
    if args.trace:
        with open(args.trace) as f:
            trace = json.load(f)
    weights = tenant_weights(tenants)
    if cfg.family == "dlrm":
        ex = engine.dlrm_extras
        stream = dlrm_stream(
            args.requests, tenants=weights, rate_rps=args.rate,
            arrival=args.arrival, seed=args.seed,
            lookup_batch=min(ex.batch, 10), table_rows=ex.table_rows,
            n_tables=ex.n_tables, trace=trace)
    else:
        stream = chat_stream(
            args.requests, tenants=weights, rate_rps=args.rate,
            arrival=args.arrival, seed=args.seed,
            mean_prompt=max(args.prompt_len // 2, 4),
            max_prompt=args.prompt_len,
            mean_output=max(args.decode_tokens // 2, 1),
            max_output=args.decode_tokens, trace=trace)

    inject = None
    if args.inject_step:
        inject = [FaultInjection(step=s, victim=args.inject_victim,
                                 persistent=args.inject_persistent,
                                 seed=args.seed + 17 * i)
                  for i, s in enumerate(sorted(args.inject_step))
                  if s >= 0]

    obs = None
    if args.obs_dir or args.monitor or args.adaptive:
        from repro_torch.obs import Observability
        obs = Observability.create()
        if args.obs_dir and args.obs_flush_every > 0:
            obs.open_incremental(args.obs_dir, every=args.obs_flush_every)
    monitor = None
    if args.monitor or args.adaptive:
        from repro_torch.obs import Monitor
        monitor = Monitor()
    adapt = None
    if args.adaptive:
        from repro_torch.adapt import (AdaptiveThresholds,
                                       ControllerConfig,
                                       calibrate_from_sweep)
        adapt = AdaptiveThresholds(
            config=ControllerConfig(fp_budget=args.fp_budget),
            source="launch.serve")
        if args.calibrate_from:
            bound = calibrate_from_sweep(args.calibrate_from,
                                         fp_budget=args.fp_budget)
            for t in tenants:
                adapt.manage("embedding_bag", t.name, rel_bound=bound)
            log.info("adaptive: calibrated embedding_bag rel_bound=%.3g "
                     "from %s", bound, args.calibrate_from)

    log.info("serving %d %s requests (%s arrivals @ %g rps) on %s, "
             "%d slots, %d lane(s)...", args.requests, cfg.family,
             args.arrival, args.rate, engine.device, args.slots,
             len(engine.lanes))
    try:
        telemetry = engine.run(stream, inject=inject, obs=obs,
                               monitor=monitor, adapt=adapt)
    except ValueError as e:             # a victim pattern matching no leaf
        ap.error(str(e))
    s = telemetry.summary()

    log.info("")
    if cfg.family == "dlrm":
        log.info("%d requests / %d steps in %.3fs of traffic, queue depth "
                 "max %d", s["requests"], s["steps"], s["span_s"],
                 s["queue_depth_max"])
        for tname, ts in s["per_tenant"].items():
            log.info("  %-10s n=%-4d done=%-4d abort=%-3d "
                     "e2e p50/p95/p99 = %.3f/%.3f/%.3f ms", tname,
                     ts["requests"], ts["completed"], ts["aborted"],
                     ts["e2e_ms"]["p50"], ts["e2e_ms"]["p95"],
                     ts["e2e_ms"]["p99"])
    else:
        log.info("%d requests / %d steps in %.3fs of traffic — "
                 "%.1f tok/s, queue depth max %d, decode occupancy %.2f",
                 s["requests"], s["steps"], s["span_s"],
                 s["throughput_tok_s"], s["queue_depth_max"],
                 s["decode_occupancy_mean"])
        for tname, ts in s["per_tenant"].items():
            log.info("  %-10s n=%-4d done=%-4d abort=%-3d "
                     "TTFT p50/p95/p99 = %.1f/%.1f/%.1f ms   "
                     "tok p99 = %.2f ms", tname, ts["requests"],
                     ts["completed"], ts["aborted"],
                     ts["ttft_ms"]["p50"], ts["ttft_ms"]["p95"],
                     ts["ttft_ms"]["p99"], ts["per_token_ms"]["p99"])
    nz = {k: v for k, v in s["faults"]["counters"].items() if v}
    log.info("fault counters: %s", nz or "all zero")
    if monitor is not None:
        ms = s.get("monitor") or monitor.summary()
        log.info("monitor: %d evaluation tick(s), %d alert(s) fired, "
                 "health %s", ms["ticks"], ms["alerts_fired"],
                 ms["health"] or "{}")
        for a in ms["alerts"]:
            log.info("  alert %-16s [%s] %s: %s=%.4g %s %.4g at t=%.3fs%s",
                     a["rule"], a["severity"], a["scope"], a["metric"],
                     a["value"], ">=", a["threshold"], a["t_s"],
                     "" if a["resolved_t_s"] is None
                     else f" (resolved t={a['resolved_t_s']:.3f}s)")
        for tr in ms["transitions"]:
            log.info("  health %-16s %s -> %s at tick %d (%s)",
                     tr["scope"], tr["old"], tr["new"], tr["tick"],
                     tr["reason"] or "recovered")
    if adapt is not None:
        for c in s.get("thresholds") or adapt.summary():
            log.info("threshold %s/%s: rel_bound=%.3g after %d move(s), "
                     "%sconverged%s", c["op"], c["tenant"],
                     c["rel_bound"], c["adjustments"],
                     "" if c["converged"] else "NOT ",
                     "" if c["ticks_to_converge"] is None
                     else f" at tick {c['ticks_to_converge']}")
    for lane_key, st in engine.paging_stats().items():
        log.info("paging %s: resident=%d/%d high-water=%d "
                 "prefix-hit=%.2f evictions=%d rebuilds=%d", lane_key,
                 st["pages_resident"],
                 st["pages_resident"] + st["pages_free"],
                 st["pages_high_water"], st["prefix_hit_rate"],
                 st["page_evictions"], st["page_rebuilds"])
    for inj in telemetry.injections:
        if inj.detected:
            log.info(">>> injected %s at step %d: DETECTED after %d "
                     "step(s) (%.2f ms)", inj.victim, inj.step,
                     inj.latency_steps, 1e3 * inj.latency_s)
        else:
            log.info(">>> injected %s at step %d: NOT detected "
                     "(masked or escaped)", inj.victim, inj.step)
    if args.obs_dir:
        for kind, path in sorted(obs.write(args.obs_dir).items()):
            log.info("obs %s: %s", kind, path)
    if args.json:
        os.makedirs(os.path.dirname(args.json) or ".", exist_ok=True)
        with open(args.json, "w") as fp:
            json.dump(telemetry.to_dict(), fp, indent=2)
        log.info("telemetry written to %s", args.json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
