"""The port's detection-health monitor (``repro_torch.obs.monitor`` and
``obs.health``) and the serving engine's live responses, against the JAX
package's, on the CPU.

Unit cases (JAX ``tests/test_monitor.py``'s) and seeded random event
streams are folded into both packages' ``Monitor`` s: ``summary()``,
``estimate()``, alerts and transitions must be equal exactly.

The engine cases serve a reduced Llama with every arrival at t = 0, so
both engines batch the same requests into the same steps (their clock is
wall time; a burst takes it out of admission).  The JAX engine runs op
by op (ROADMAP §C5) on the same weights; a weight flip's element is
JAX's (the port draws it from a ``torch.Generator``).  Every event field
is compared but the times (``t_s``, step durations).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.obs import health as jhealth, monitor as jmon  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.obs import health as thealth, monitor as tmon  # noqa: E402

from test_torch_obs import _untimed, _untimed_registry, \
    mirrored_lines  # noqa: E402

PKGS = ((tobs, tmon, thealth), (jobs, jmon, jhealth))


def _untimed_summary(s: dict) -> dict:
    """A monitor summary with the wall-time fields left out."""
    s = json.loads(json.dumps(s))
    for a in s["alerts"] + s["active_alerts"]:
        a.pop("t_s")
        a["resolved"] = a.pop("resolved_t_s") is not None
    for t in s["transitions"]:
        t.pop("t_s")
    return s


# ------------------------------ primitives ----------------------------------

def test_wilson_interval_equals_jax():
    for k, n in [(0, 0), (0, 50), (0, 500), (8, 40), (1, 3), (5, 7),
                 (99, 100), (3675, 15360)]:
        assert tmon.wilson_interval(k, n) == jmon.wilson_interval(k, n)
    assert tmon.RULE_METRICS == jmon.RULE_METRICS


def test_wilson_interval_reads_more_errors_than_checks_as_all():
    """An EmbeddingBag call counts one check and one error a flagged bag,
    so a window can hold more errors than checks.  Both monitors then
    raise, the port as the JAX package does (ROADMAP §C9): the window
    below, folded into each, fails the same way."""
    for k, n in [(3, 1), (40, 32), (2, 1)]:
        for mod in (tmon, jmon):
            with pytest.raises(ValueError, match="math domain"):
                mod.wilson_interval(k, n)
    for pkg in (tobs, jobs):
        mon = pkg.Monitor()
        for i in range(40):
            mon.record_step(float(i), {"embedding_bag": (1, 3)},
                            tenants=("a",))
        est = mon.estimate
        with pytest.raises(ValueError, match="math domain"):
            est(op="embedding_bag", window_ticks=32)


@pytest.mark.parametrize("kw", [
    dict(metric="nope", threshold=1), dict(metric="detections",
                                           threshold=1, cmp="!!"),
    dict(metric="detections", threshold=1, severity="explode"),
    dict(metric="detections", threshold=1, window_ticks=0, window_s=0.0)])
def test_alert_rule_validation_as_jax(kw):
    msgs = []
    for pkg, _, _ in PKGS:
        with pytest.raises(ValueError) as ei:
            pkg.AlertRule(name="x", **kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


def test_default_rules_and_scopes_are_the_jax_ones():
    assert [r.to_dict() for r in tobs.default_rules()] == \
        [r.to_dict() for r in jobs.default_rules()]
    for args in (("qgemm", "prem", "c0"), ("qgemm", "", "c0"),
                 ("qgemm", "", "")):
        assert tmon.health_scope(*args) == jmon.health_scope(*args)
    assert tobs.HealthPolicy().to_dict() == jobs.HealthPolicy().to_dict()
    assert tobs.EngineResponses().to_dict() == \
        jobs.EngineResponses().to_dict()


@pytest.mark.parametrize("seed", range(6))
def test_health_tracker_walks_as_jax(seed):
    """A seeded alert/clean sequence (quarantine-grade ticks included)
    through both trackers: every transition and every probe answer."""
    rng = np.random.default_rng(seed)
    pol = dict(degrade_after=int(rng.integers(1, 3)),
               quarantine_after=int(rng.integers(1, 4)),
               recover_after=int(rng.integers(1, 5)),
               probe_every=int(rng.integers(1, 5)))
    trackers = [h.HealthTracker("tenant:a", h.HealthPolicy(**pol))
                for _, _, h in PKGS]
    for i in range(80):
        alerting = bool(rng.random() < 0.35)
        grade = bool(rng.random() < 0.2)
        probe = bool(rng.random() < 0.5)
        outs = []
        for tr in trackers:
            t = tr.update(alerting, float(i), quarantine_grade=grade,
                          reason="r" if alerting else "")
            outs.append((None if t is None else t.to_dict(),
                         tr.take_probe() if probe else None, tr.state))
        assert outs[0] == outs[1]
    assert trackers[0].to_dict() == trackers[1].to_dict()


# ------------------------------ unit scenarios ------------------------------

def _sc_ages_out(pkg):
    mon = pkg.Monitor(
        rules=[pkg.AlertRule(name="burst", metric="detections",
                             threshold=3, window_ticks=4)],
        health=pkg.HealthPolicy(degrade_after=1, quarantine_after=3,
                                recover_after=2, probe_every=2))
    t = 0.0
    for e in (0, 0, 0, 1, 1, 1):
        t += 1.0
        mon.record_step(t, {"qgemm": (2, e)}, tenants=("a",))
    assert mon.tenant_state("a") == "degraded"
    assert mon.admission_allowed("a")
    for _ in range(10):
        t += 0.001
        mon.idle_tick(t)
    assert mon.tenant_state("a") == "healthy"
    return mon, None


def _sc_fp_proxy(pkg):
    rule = pkg.AlertRule(name="fp", metric="fp_rate_low", threshold=0.02,
                         cmp=">", window_ticks=8, min_checks=20)
    mon = pkg.Monitor(rules=[rule])
    obs = pkg.Observability.create()
    mon.bind(obs)
    obs.bus.emit(pkg.FaultEvent(op="qgemm", step=0, source="t",
                                kind="injection", t_s=0.5))
    for i in range(12):
        obs.bus.emit(pkg.FaultEvent(
            op="step", step=i, source="t", kind="info", t_s=1.0 + i,
            attrs={"channel": "step", "by_op": {"qgemm": [5, 2]},
                   "tenants": ["a"]}))
    return mon, obs


def _sc_burn_rate(pkg):
    mon = pkg.Monitor(rules=[pkg.AlertRule(
        name="burn", metric="detections", threshold=2, window_ticks=2,
        long_window_ticks=8, long_threshold=4)])
    for i in range(4):
        mon.record_step(float(i + 1), {"q": (1, 1)})
    assert mon.state("op:q") == "degraded"
    return mon, None


def _sc_latency(pkg):
    mon = pkg.Monitor(rules=[pkg.AlertRule(
        name="slow", metric="latency_p99_ms", threshold=100.0,
        window_ticks=4, min_samples=3, op="step/serve", severity="warn")])
    for i, ms in enumerate((5.0, 5.0, 5.0, 5.0, 250.0, 250.0, 250.0)):
        mon.record_step(float(i + 1), {}, tenants=("a",), duration_ms=ms,
                        kind="serve")
    assert mon.tenant_state("a") == "healthy"
    return mon, None


def _sc_cell_events(pkg):
    mon = pkg.Monitor(rules=[pkg.AlertRule(
        name="cellburst", metric="detections", threshold=5,
        window_ticks=4)])
    obs = pkg.Observability.create()
    mon.bind(obs)
    obs.registry.counter("repro_detections_total").inc(6, cell="c1")
    obs.registry.counter("repro_injections_total").inc(8, cell="c1")
    obs.bus.emit(pkg.FaultEvent(
        op="soak", step=0, source="serving.soak", kind="cell",
        cell_id="c1", errors=7, checks=8, t_s=1.0,
        attrs={"effective_detected": 6, "escapes": 1,
               "false_positives": 0}))
    assert mon.state("cell:c1") == "degraded"
    return mon, obs


def _sc_time_windows(pkg):
    mon = pkg.Monitor(rules=[
        pkg.AlertRule(name="rate", metric="detections_per_s",
                      threshold=1.5, window_ticks=0, window_s=2.0),
        pkg.AlertRule(name="esc", metric="escape_proxy", threshold=1,
                      window_ticks=0, window_s=3.0, severity="warn"),
        pkg.AlertRule(name="hi", metric="flag_rate_high", threshold=0.9,
                      window_ticks=0, window_s=3.0, min_checks=4)])
    obs = pkg.Observability.create()
    mon.bind(obs)
    for i in range(10):
        if i in (2, 6):
            obs.bus.emit(pkg.FaultEvent(op="q", step=i, source="t",
                                        kind="injection", t_s=0.5 * i))
        mon.record_step(0.5 * i, {"q": (2, int(i % 3 == 0))},
                        tenants=("a", "b"))
    return mon, obs


SCENARIOS = [_sc_ages_out, _sc_fp_proxy, _sc_burn_rate, _sc_latency,
             _sc_cell_events, _sc_time_windows]


@pytest.mark.parametrize("scenario", SCENARIOS,
                         ids=[f.__name__[4:] for f in SCENARIOS])
def test_unit_scenarios_equal_jax(scenario):
    (tm, to), (jm, jo) = (scenario(pkg) for pkg, _, _ in PKGS)
    assert tm.summary() == jm.summary()
    for kw in ({}, {"op": "q*"}, {"tenant": "a", "window_ticks": 3}):
        assert tm.estimate(**kw) == jm.estimate(**kw)
    assert [a.to_dict() for a in tm.active_alerts()] == \
        [a.to_dict() for a in jm.active_alerts()]
    if to is not None:
        assert [e.to_dict() for e in to.bus] == \
            [e.to_dict() for e in jo.bus]
        assert to.registry.to_prometheus() == jo.registry.to_prometheus()
        for ev in to.bus:
            jobs.validate_event(ev.to_dict())
        assert tobs.replay(to.bus).to_prometheus() == \
            jobs.replay(jo.bus).to_prometheus()


def _random_stream(pkg, rng, n):
    """Step summaries (one to three tenants, 1-3 ops, bursts of flags),
    injections and cell events, as the engine and the soaks publish."""
    events = []
    for i in range(n):
        t = 0.01 * i
        r = rng.random()
        if r < 0.08:
            events.append(pkg.FaultEvent(op="layers.mlp.down", step=i,
                                         source="s", kind="injection",
                                         t_s=t))
        elif r < 0.12:
            events.append(pkg.FaultEvent(
                op="soak", step=0, source="s", kind="cell", t_s=t,
                cell_id=f"c{int(rng.integers(2))}",
                errors=int(rng.integers(0, 9)), checks=8))
        else:
            burst = rng.random() < 0.15
            by_op = {op: [int(rng.integers(1, 60)),
                          int(rng.integers(1, 4)) if burst and
                          rng.random() < 0.7 else 0]
                     for op in rng.choice(["qgemm", "embedding_bag",
                                           "kv_cache"],
                                          int(rng.integers(1, 4)),
                                          replace=False)}
            tenants = sorted(rng.choice(["a", "b", "c"],
                                        int(rng.integers(1, 3)),
                                        replace=False))
            events.append(pkg.FaultEvent(
                op="step", step=i, source="serving.engine", kind="info",
                t_s=t, attrs={"channel": "step", "by_op": by_op,
                              "tenants": [str(x) for x in tenants],
                              "duration_ms": float(rng.random() * 20),
                              "kind": "decode"}))
        if rng.random() < 0.05:
            events.append(None)                   # an idle tick
    return events


@pytest.mark.parametrize("seed", range(5))
def test_random_streams_fold_to_equal_summaries(seed):
    """The same seeded stream through both monitors (default rules, a
    tight health policy so states move): equal ``summary()``,
    ``estimate()`` at several windows, alert and health events."""
    outs = []
    for pkg, _, _ in PKGS:
        rng = np.random.default_rng(seed)
        obs = pkg.Observability.create()
        mon = pkg.Monitor(health=pkg.HealthPolicy(
            degrade_after=1, quarantine_after=2, recover_after=3,
            probe_every=2)).bind(obs)
        probes = []
        for i, ev in enumerate(_random_stream(pkg, rng, 300)):
            if ev is None:
                mon.idle_tick(0.01 * i)
            else:
                obs.bus.emit(ev)
            probes.append([mon.admission_allowed(t) for t in "abc"])
            probes.append([t.to_dict() for t in mon.poll_transitions()])
        ests = [mon.estimate(op=op, tenant=tn, window_ticks=w)
                for op in ("*", "qgemm", "kv_*") for tn in ("*", "a")
                for w in (4, 32, 128)]
        outs.append((mon.summary(), ests, probes,
                     [e.to_dict() for e in obs.bus],
                     obs.registry.to_prometheus()))
    assert outs[0] == outs[1]
    assert outs[0][0]["alerts_fired"] > 0


def test_monitor_ignores_its_own_emissions():
    for pkg, _, _ in PKGS:
        mon = pkg.Monitor(rules=[pkg.AlertRule(
            name="b", metric="detections", threshold=1, window_ticks=4)])
        obs = pkg.Observability.create()
        mon.bind(obs)
        mon.bind(obs)                             # idempotent
        for i in range(4):
            obs.bus.emit(pkg.FaultEvent(
                op="step", step=i, source="t", kind="info", t_s=1.0 + i,
                attrs={"channel": "step", "by_op": {"q": [1, 1]},
                       "tenants": ["a"]}))
        assert [e for e in obs.bus if e.kind == "alert"]
        assert mon.summary()["ticks"] == 4


# ------------------------- serving engine integration -----------------------

BURST = (4, 5, 6)


@pytest.fixture(scope="module")
def engines():
    from repro.configs import reduce_cfg
    from repro.configs.registry import get_arch
    from repro.protect import ProtectionPlan as JPlan
    from repro.serving import ServingEngine as JEngine, TenantSpec as JT
    from repro_torch.configs import get_arch as t_arch, reduce_cfg as t_red
    from repro_torch.models.convert import from_jax
    from repro_torch.protect import ProtectionPlan as TPlan
    from repro_torch.serving import ServingEngine as TEngine, TenantSpec as TT

    kw = dict(n_slots=2, max_prompt=8, max_new_tokens=4, seed=0)
    je = JEngine(reduce_cfg(get_arch("llama3.2-1b")),
                 [JT("t", JPlan.parse("*:policy=log", name="t"))], **kw)
    te = TEngine(t_red(t_arch("llama3.2-1b")),
                 [TT("t", TPlan.parse("*:policy=log", name="t"))],
                 device="cpu", **kw)
    te.params = from_jax(jax.tree.map(np.asarray, je.params), device="cpu")
    return je, te


def _burst_stream(n, seed=3):
    from repro_torch.serving import chat_stream
    return [dataclasses.replace(r, arrival_s=0.0) for r in chat_stream(
        n, tenants={"t": 1.0}, rate_rps=500.0, seed=seed, mean_prompt=6,
        max_prompt=8, mean_output=3, max_output=4)]


def _jax_coords(je, seed):
    """JAX's flipped (flat index, bit) of ``mlp.down`` for a seed."""
    from repro.core.inject import random_bitflip_live, victim_leaf_index
    leaves = jax.tree_util.tree_leaves(je.params)
    idx, path = victim_leaf_index(je.params, "mlp.down")
    clean = np.asarray(leaves[idx]).reshape(-1)
    bad = np.asarray(random_bitflip_live(jax.random.key(seed), leaves[idx],
                                         path)).reshape(-1)
    (flat,) = np.flatnonzero(clean != bad)
    x = int(clean[flat].view(np.uint8)) ^ int(bad[flat].view(np.uint8))
    return int(flat), x.bit_length() - 1


def _serve_both(engines, monkeypatch, n, responses=None):
    """The burst scenario on both engines: three ``mlp.down`` flips at
    steps 4, 5 and 6, a default ``Monitor``; returns both (telemetry,
    obs, monitor) triples."""
    import repro_torch.core.inject as tinj
    from repro.serving import FaultInjection as JInj
    from repro_torch.serving import FaultInjection as TInj

    je, te = engines
    coords = iter([_jax_coords(je, i) for i in range(len(BURST))])
    monkeypatch.setattr(tinj, "draw_bitflip_live",
                        lambda gen, leaf, path="", bit_range=None:
                        next(coords))
    out = []
    for eng, pkg, inj in ((je, jobs, JInj), (te, tobs, TInj)):
        eng.reset_state()
        eng._escalated.clear()
        for lane in eng.lanes:        # undo an earlier run's escalation
            lane.plan = eng.tenants["t"].resolved_plan()
            eng._build_lane_fns(lane)
        obs = pkg.Observability.create()
        mon = pkg.Monitor(responses=responses(pkg) if responses else None)
        burst = [inj(step=s, victim="mlp.down", seed=i)
                 for i, s in enumerate(BURST)]
        if eng is je:
            with jax.disable_jit():
                tel = eng.run(_burst_stream(n), inject=burst, obs=obs,
                              monitor=mon)
        else:
            tel = eng.run(_burst_stream(n), inject=burst, obs=obs,
                          monitor=mon)
        out.append((tel, obs, mon))
    return out


@pytest.fixture(scope="module")
def burst_runs(engines):
    mp = pytest.MonkeyPatch()
    try:
        return _serve_both(engines, mp, 24)
    finally:
        mp.undo()


def test_burst_to_quarantine_and_back_equals_jax(burst_runs, engines,
                                                 tmp_path):
    """The acceptance scenario: the fault burst drives alert → degraded
    → quarantined → engine responses → probe recovery; the port's event
    stream, registry, transitions and responses equal JAX's, and every
    link is reconstructible from the exported JSONL alone."""
    (jtel, jo, jm), (ttel, to, tm) = burst_runs
    assert _untimed(to.bus) == _untimed(jo.bus)
    assert _untimed_registry(to.registry) == _untimed_registry(jo.registry)
    assert _untimed_summary(tm.summary()) == _untimed_summary(jm.summary())
    assert [(e.step, e.kind, e.lane, e.slot_rids, e.errors)
            for e in ttel.steps] == [(e.step, e.kind, e.lane, e.slot_rids,
                                      e.errors) for e in jtel.steps]
    s = ttel.summary()
    assert {a["rule"] for a in s["monitor"]["alerts"]} >= {
        "detection-burst"}
    assert all(a["resolved_t_s"] is not None
               for a in s["monitor"]["alerts"])
    hops = [(x["old"], x["new"]) for x in s["monitor"]["transitions"]]
    assert hops[0][0] == "healthy" and \
        any(new == "quarantined" for _, new in hops)
    assert s["monitor"]["health"] == {"tenant:t": "healthy"}
    assert s["per_tenant"]["t"]["completed"] == 24
    assert ttel.summary()["monitor"] == tm.summary()

    paths = to.write(str(tmp_path))
    events = [json.loads(ln) for ln in open(paths["events"])]
    for d in events:
        tobs.validate_event(d)
        jobs.validate_event(d)
    seq = [(d["attrs"]["from"], d["attrs"]["to"]) for d in events
           if d["kind"] == "health" and d["source"] == "obs.monitor"]
    assert seq[0][0] == "healthy" and seq[-1][1] == "healthy"
    actions = [d["attrs"]["action"] for d in events
               if d["kind"] == "health" and d["source"] == "serving.engine"]
    assert {"escalate", "quarantine", "recover"} <= set(actions)
    # the lane was escalated: log -> recompute, in both engines
    for eng in engines:
        plan = eng._lane_of["t"].plan
        assert plan.resolve("qgemm").policy == "recompute"
        assert plan.name == "t+escalated"
    for pkg in (tobs, jobs):
        assert mirrored_lines(pkg.replay(paths["events"])) == \
            mirrored_lines(to.registry)


def test_detection_events_carry_the_resident_request_ids(burst_runs):
    """Each detection event names the requests resident in the flagged
    step's slots (in step order: one event per flagged op of each
    flagged step), and the registry's error counters equal the timeline's
    totals; spans and step counters cover every step."""
    _, (tel, obs, _) = burst_runs
    detections = [e for e in obs.bus if e.kind == "detection"]
    flagged = [ev for ev in tel.steps if ev.errors > 0]
    assert detections and len(detections) == len(flagged)
    for e, ev in zip(detections, flagged):
        assert (e.step, e.request_ids) == (ev.step, ev.slot_rids)
        assert len(e.request_ids) >= 1
    totals = tel.fault_counters()
    errs = obs.registry.counter("repro_abft_errors_total")
    assert errs.value(op="qgemm", source="serving.engine") == \
        totals["qgemm_errors"]
    assert obs.registry.counter("repro_steps_total").total() == \
        len(tel.steps)
    assert len([s for s in obs.tracer.spans if s.cat == "serving"]) == \
        len(tel.steps)
    injections = [e for e in obs.bus if e.kind == "injection"]
    assert [e.step for e in injections] == list(BURST)
    assert all("mlp.down" in e.op for e in injections)


def test_responses_disabled_equals_jax(engines, monkeypatch):
    (jtel, jo, jm), (ttel, to, tm) = _serve_both(
        engines, monkeypatch, 12,
        responses=lambda pkg: pkg.EngineResponses(
            quarantine=False, escalate=False, scrub=False))
    assert _untimed(to.bus) == _untimed(jo.bus)
    assert _untimed_summary(tm.summary()) == _untimed_summary(jm.summary())
    actions = {e.attrs.get("action") for e in to.bus
               if e.kind == "health" and e.source == "serving.engine"}
    assert "quarantine" not in actions and "escalate" not in actions
    assert ttel.summary()["monitor"]["alerts_fired"] >= 1


def test_campaign_cli_quick_with_monitor_and_obs_dir(tmp_path, capsys):
    from repro_torch.campaign import __main__ as cli

    out = tmp_path / "obs"
    assert cli.main(["--grid", "pallas", "--quick", "--device", "cpu",
                     "--samples", "8", "--monitor", "--obs-dir", str(out),
                     "--out", str(tmp_path)]) == 0
    text = capsys.readouterr().out
    assert "monitor:" in text and "obs events:" in text
    bus = tobs.EventBus.from_jsonl(str(out / "obs_events.jsonl"))
    cells = [e for e in bus if e.kind == "cell"]
    assert len(cells) == 7
    assert mirrored_lines(tobs.replay(bus)) == mirrored_lines(
        tobs.replay(jobs.EventBus.from_jsonl(
            str(out / "obs_events.jsonl"))))
