"""Serving SLO benchmark: what does protection cost under live traffic?
(the JAX package's ``benchmarks/serving_slo.py``)

Runs the SAME seeded request stream through the serving engine under a
ladder of protection plans — unprotected, log-only, recompute+QuantKV —
and reports per-tenant p50/p95/p99 TTFT, per-token latency, and
throughput side by side, plus the protected-over-unprotected p99 ratios.
This is the paper's overhead argument (< 20% for the GEMM, < 26% for the
EmbeddingBag, per kernel) restated in SLO terms: the kernel overhead only
matters insofar as it moves these tails.  The unprotected rung runs K1's
and K2's unprotected instances on the card (``QGEMM.unprotected``,
``EMBEDDING_BAG.unprotected``).

    python -m repro_torch.benchmarks.serving_slo --quick --device cpu
    python -m repro_torch.benchmarks.serving_slo --arch granite-moe-3b-a800m \\
        --requests 16 --rate 300 --out bench/

On the card every time is the engine's step wall time, ended by a
synchronize; on the CPU (``--device cpu``) the plain versions run, and
the times are host times of the CPU, not a device metric.
"""
from __future__ import annotations

import argparse
import json
import os
import time


PLANS = (
    ("unprotected", "*:off"),
    ("log", "*:policy=log"),
    ("recompute+kv", "*:policy=recompute,kv_cache:on"),
)


def run_ladder(arch, *, requests: int, rate: float, arrival: str,
               slots: int, max_new: int, seed: int, smoke: bool,
               device="cuda", emit=print, probe=None) -> dict:
    """Serve one stream under each plan of :data:`PLANS`; returns the
    ``BENCH_serving_slo`` dict.  ``arch`` is a registered name or an
    ``ArchConfig`` (a caller's cut of one).  ``probe(name, engine)``,
    where given, is called after each rung's run while its engine lives
    (a caller's launch counts or device-operation check)."""
    from repro_torch.campaign.artifacts import environment_info
    from repro_torch.configs.registry import get_arch
    from repro_torch.device import resolve_device
    from repro_torch.protect import ProtectionPlan
    from repro_torch.serving import ServingEngine, TenantSpec, chat_stream

    dev = resolve_device(device)
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if smoke:
        from repro_torch.configs import reduce_cfg
        cfg = reduce_cfg(cfg)

    rows = {}
    stream_kw = dict(rate_rps=rate, arrival=arrival, seed=seed,
                     mean_prompt=24, max_prompt=32,
                     mean_output=max(max_new // 2, 1), max_output=max_new)
    for name, plan_text in PLANS:
        engine = ServingEngine(
            cfg, [TenantSpec("t", ProtectionPlan.parse(plan_text,
                                                       name=name))],
            n_slots=slots, max_prompt=32, max_new_tokens=max_new,
            seed=seed, device=dev)
        stream = chat_stream(requests, tenants={"t": 1.0}, **stream_kw)
        t0 = time.perf_counter()
        telemetry = engine.run(stream)
        s = telemetry.summary()
        ts = s["per_tenant"]["t"]
        rows[name] = {
            "plan": plan_text,
            "ttft_ms": ts["ttft_ms"],
            "per_token_ms": ts["per_token_ms"],
            "e2e_ms": ts["e2e_ms"],
            "throughput_tok_s": s["throughput_tok_s"],
            "span_s": s["span_s"],
            "wall_s": time.perf_counter() - t0,
            "completed": ts["completed"],
            "steps": len(telemetry.steps),
            "counters": s["faults"]["counters"],
        }
        if probe is not None:
            probe(name, engine)
        del engine                     # one model on the card at a time
        emit(f"[{name:>13}] TTFT p50/p95/p99 = "
             f"{ts['ttft_ms']['p50']:.2f}/{ts['ttft_ms']['p95']:.2f}/"
             f"{ts['ttft_ms']['p99']:.2f} ms  "
             f"tok p99 = {ts['per_token_ms']['p99']:.3f} ms  "
             f"{s['throughput_tok_s']:.0f} tok/s")

    base = rows["unprotected"]
    for name in rows:
        if name == "unprotected":
            continue
        rows[name]["ttft_p99_ratio"] = (
            rows[name]["ttft_ms"]["p99"] / base["ttft_ms"]["p99"]
            if base["ttft_ms"]["p99"] > 0 else float("nan"))
        rows[name]["tok_p99_ratio"] = (
            rows[name]["per_token_ms"]["p99"]
            / base["per_token_ms"]["p99"]
            if base["per_token_ms"]["p99"] > 0 else float("nan"))
        emit(f"{name}: p99 TTFT ×{rows[name]['ttft_p99_ratio']:.3f}, "
             f"p99 per-token ×{rows[name]['tok_p99_ratio']:.3f} "
             f"vs unprotected")
    return {"arch": cfg.name, "requests": requests, "rate_rps": rate,
            "arrival": arrival, "slots": slots, "seed": seed,
            "env": environment_info(dev), "plans": rows}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.serving_slo",
        description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="llama3.2-1b",
                    help="llama3.2-1b, qwen3-8b, granite-moe-3b-a800m or "
                         "rwkv6-1.6b")
    ap.add_argument("--requests", type=int, default=100)
    ap.add_argument("--rate", type=float, default=300.0)
    ap.add_argument("--arrival", default="poisson",
                    choices=["poisson", "bursty"])
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--decode-tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--quick", action="store_true",
                    help="reduced model + 40 requests")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engines run (default: the card; no "
                         "fallback)")
    ap.add_argument("--out", default=None,
                    help="directory for BENCH_serving_slo.json")
    args = ap.parse_args(argv)

    requests = 40 if args.quick else args.requests
    result = run_ladder(args.arch, requests=requests, rate=args.rate,
                        arrival=args.arrival, slots=args.slots,
                        max_new=args.decode_tokens, seed=args.seed,
                        smoke=args.quick, device=args.device)
    if args.out:
        os.makedirs(args.out, exist_ok=True)
        path = os.path.join(args.out, "BENCH_serving_slo.json")
        with open(path, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
        print(f"artifact: {path}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
