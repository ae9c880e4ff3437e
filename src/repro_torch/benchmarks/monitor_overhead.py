"""Measure the live monitor's per-tick cost against serving step time (the
JAX package's ``benchmarks/monitor_overhead.py``).

Wall-clock A/B of whole runs (monitored vs not) is hopeless at smoke
scale: the deltas are a few ms against the scheduler's noise.  Instead,
run ONE monitored smoke soak to capture (a) the mean engine step time and
(b) the exact event stream the monitor saw, then fold that stream into
fresh ``Monitor`` instances and time the fold alone.  Per-tick monitor
cost over per-step engine time is the overhead number — deterministic
event count, best-of-N timing — gated < 5% as
``benchmarks/baselines/BENCH_monitor_smoke.json`` states.

    python -m repro_torch.benchmarks.monitor_overhead [--device cpu] \\
        [--out OUT.json]

On the card the step time is the engine's step wall time, ended by a
synchronize; the fold is host time either way.  On the CPU the plain
versions run, and the step time is a host time of the CPU.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

REPS = 7
ACCEPT_FRAC = 0.05


def measure(device="cuda") -> dict:
    """One monitored run of the reduced Llama (32 requests at 200 rps, 4
    slots, up to 8 new tokens), then the fold of its event stream into a
    fresh :class:`~repro_torch.obs.Monitor`, best of :data:`REPS`."""
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.obs import Monitor, Observability
    from repro_torch.protect import ProtectionPlan
    from repro_torch.serving import ServingEngine, TenantSpec, chat_stream

    cfg = reduce_cfg(get_arch("llama3.2-1b"))
    tenants = [TenantSpec("t", ProtectionPlan.parse("*:policy=log",
                                                    name="t"))]
    eng = ServingEngine(cfg, tenants, n_slots=4, max_prompt=32,
                        max_new_tokens=8, seed=0, device=device)
    eng.warmup()
    stream = chat_stream(32, tenants={"t": 1.0}, rate_rps=200.0, seed=5,
                         mean_prompt=16, max_prompt=32, mean_output=4,
                         max_output=8)
    eng.reset_state()
    obs = Observability.create()
    t0 = time.perf_counter()
    tel = eng.run(stream, obs=obs, monitor=Monitor())
    run_s = time.perf_counter() - t0
    steps = len(tel.steps)
    events = list(obs.bus)

    best = float("inf")
    ticks = 0
    for _ in range(REPS):
        m2 = Monitor()
        t0 = time.perf_counter()
        for ev in events:
            m2.on_event(ev)
        best = min(best, time.perf_counter() - t0)
        ticks = m2.summary()["ticks"]

    per_tick_ms = 1e3 * best / max(1, ticks)
    per_step_ms = 1e3 * run_s / max(1, steps)
    frac = per_tick_ms / per_step_ms
    return {
        "bench": "monitor_smoke",
        "arch": "llama3.2-1b (reduced smoke config)",
        "device": str(eng.device),
        "requests": 32,
        "steps": steps,
        "ticks": ticks,
        "events": len(events),
        "reps": REPS,
        "timing": "best-of",
        "monitored_run_wall_s": run_s,
        "per_step_ms": per_step_ms,
        "monitor_per_tick_ms": per_tick_ms,
        "monitor_overhead_frac_of_step": frac,
        "monitor_overhead_pct_of_step": 100 * frac,
        "method": "fold the run's captured event stream into a fresh "
                  "Monitor (default rules), best-of-%d; per-tick cost "
                  "vs the monitored run's mean step time" % REPS,
        "acceptance": "monitor_overhead_frac_of_step < %.2f" % ACCEPT_FRAC,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.benchmarks.monitor_overhead",
        description="The live monitor's per-tick cost over the serving "
                    "step time (gated < 5%).")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="where the engine serves (default: the card)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    out = measure(args.device)
    print(json.dumps(out, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=2)
            f.write("\n")
        print(f"wrote {args.out}")
    frac = out["monitor_overhead_frac_of_step"]
    if frac >= ACCEPT_FRAC:
        print(f"FAIL: monitor overhead {100 * frac:.2f}% of step time "
              f"(accept < {100 * ACCEPT_FRAC:.0f}%)")
        return 1
    print(f"monitor overhead OK: {100 * frac:.2f}% of step time "
          f"(< {100 * ACCEPT_FRAC:.0f}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
