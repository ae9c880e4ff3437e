"""The port's observability layer (``repro_torch.obs``: events, metrics,
trace, the bundle and ``replay``; ``protect.runtime.observe_metrics``;
the serving engine's paging events; the serve CLI's ``--obs-dir``)
against the JAX package's ``repro.obs``, on the CPU.

Both packages are fed the same calls, drawn from numpy generators at
fixed seeds; counters, event fields and Prometheus text must be equal
exactly (line for line), and each package reads the other's JSONL.
Times are the only fields left out: span and event times are wall time.
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro.protect import runtime as jrt  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.protect import runtime as trt  # noqa: E402

#: registry families the counter-mirror invariant covers (JAX
#: tests/test_monitor.py's list)
MIRRORED = ("repro_detections_total", "repro_injections_total",
            "repro_abft_checks_total", "repro_abft_errors_total",
            "repro_alerts_total", "repro_health_transitions_total",
            "repro_health_state", "repro_health_actions_total",
            "repro_escapes_total", "repro_false_positives_total",
            "repro_paging_ops_total")


def mirrored_lines(registry):
    return sorted(ln for ln in registry.to_prometheus().splitlines()
                  if ln.startswith(MIRRORED))


def _event_kwargs(rng, i):
    kind = str(rng.choice(tobs.EVENT_KINDS))
    return dict(
        op=str(rng.choice(["qgemm", "embedding_bag", "kv_cache", "step"])),
        step=int(rng.integers(0, 50)), source="t", kind=kind,
        t_s=float(i) * 0.25, errors=int(rng.integers(0, 4)),
        checks=int(rng.integers(0, 9)),
        cell_id=None if rng.random() < 0.5 else f"c{int(rng.integers(3))}",
        shard=None if rng.random() < 0.5 else int(rng.integers(4)),
        bit_band=None if rng.random() < 0.5 else "low",
        detector_value=None if rng.random() < 0.5 else float(rng.random()),
        bound=None if rng.random() < 0.5 else 1e-5,
        request_ids=tuple(int(r) for r in rng.integers(0, 9,
                                                       rng.integers(3))),
        attrs={"lane": int(rng.integers(2))})


# ------------------------------ events --------------------------------------

def test_schema_constants_are_the_jax_ones():
    assert tobs.EVENT_SCHEMA_VERSION == jobs.EVENT_SCHEMA_VERSION
    assert tobs.EVENT_KINDS == jobs.EVENT_KINDS
    assert tobs.EVENT_SCHEMA == jobs.EVENT_SCHEMA
    assert tobs.DEFAULT_BUCKETS == jobs.DEFAULT_BUCKETS
    assert tobs.HEALTH_STATES == jobs.HEALTH_STATES


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_event_dicts_equal_and_validate_across_packages(seed):
    rng = np.random.default_rng(seed)
    for i in range(20):
        kw = _event_kwargs(rng, i)
        td = tobs.FaultEvent(**kw).to_dict()
        jd = jobs.FaultEvent(**kw).to_dict()
        assert td == jd
        for validate in (tobs.validate_event, jobs.validate_event):
            validate(json.loads(json.dumps(td)))
            validate(json.loads(json.dumps(jd)))
        assert tobs.FaultEvent.from_dict(jd) == tobs.FaultEvent(**kw)


@pytest.mark.parametrize("mutate", [
    lambda d: d.pop("op"), lambda d: d.update(kind="explosion"),
    lambda d: d.update(step="seven"),
    lambda d: d.update(request_ids=[1, "x"]),
    lambda d: d.update(schema=tobs.EVENT_SCHEMA_VERSION + 1)])
def test_validate_event_rejects_as_jax_does(mutate):
    msgs = []
    for pkg in (tobs, jobs):
        d = pkg.FaultEvent(op="qgemm", step=0, source="t").to_dict()
        mutate(d)
        with pytest.raises(ValueError) as ei:
            pkg.validate_event(d)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("writer,reader", [(tobs, jobs), (jobs, tobs)])
def test_jsonl_read_across_packages(tmp_path, writer, reader):
    rng = np.random.default_rng(7)
    bus = writer.EventBus()
    for i in range(30):
        bus.emit(writer.FaultEvent(**_event_kwargs(rng, i)))
    path = bus.to_jsonl(str(tmp_path / "ev.jsonl"))
    back = reader.EventBus.from_jsonl(path)
    assert [e.to_dict() for e in back] == [e.to_dict() for e in bus]
    assert back.counters() == bus.counters()
    merged = reader.EventBus.merged(back, reader.EventBus(), back)
    assert merged.counters() == {k: 2 * v for k, v in
                                 bus.counters().items()}


def test_bad_record_and_old_schema_files_as_jax(tmp_path):
    good = tobs.FaultEvent(op="qgemm", step=0, source="t").to_dict()
    bad = tmp_path / "bad.jsonl"
    bad.write_text(json.dumps(good) + "\n"
                   + json.dumps(dict(good, kind="nope")) + "\n")
    msgs = []
    for pkg in (tobs, jobs):
        with pytest.raises(ValueError, match=r"bad\.jsonl:2: .*kind") as e:
            pkg.EventBus.from_jsonl(str(bad))
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]
    old = tmp_path / "v1.jsonl"
    old.write_text(json.dumps(dict(good, schema=1)) + "\n"
                   + json.dumps(dict(good, schema=2, kind="alert")) + "\n")
    assert [e.to_dict() for e in tobs.EventBus.from_jsonl(str(old))] == \
        [e.to_dict() for e in jobs.EventBus.from_jsonl(str(old))]


def _metrics_dict(rng):
    """A step's metrics in any spelling in circulation: protect-layer
    ``abft/<op>_*`` keys, bare ``<op>_*`` counters, the legacy aliases,
    fractional (grad-accum) counts and the comm channel."""
    m = {}
    for op in ("qgemm", "float_gemm", "embedding_bag", "kv_cache",
               "kv_cache_paged"):
        r = rng.random()
        if r < 0.3:
            m[f"abft/{op}_checks"] = int(rng.integers(0, 9))
            m[f"abft/{op}_errors"] = float(rng.choice([0, 0.25, 1, 2]))
        elif r < 0.5:
            m[f"{op}_checks"] = int(rng.integers(0, 9))
            m[f"{op}_errors"] = int(rng.integers(0, 3))
    if rng.random() < 0.5:
        m["abft/gemm_errors"] = int(rng.integers(0, 3))
        m["abft/gemm_checks"] = 4
    if rng.random() < 0.5:
        m["abft/eb_errors"] = int(rng.integers(0, 2))
    if rng.random() < 0.3:
        m["comm/errors"] = int(rng.integers(0, 2))
        m["comm/checks"] = 1
    return m


@pytest.mark.parametrize("seed", range(4))
def test_op_counts_and_events_from_metrics_equal_jax(seed):
    from repro.obs.events import op_counts as j_counts
    from repro_torch.obs.events import op_counts as t_counts

    rng = np.random.default_rng(seed)
    for step in range(25):
        m = _metrics_dict(rng)
        assert t_counts(m) == j_counts(m)
        kw = dict(step=step, source="s", t_s=0.5, cell_id="c",
                  request_ids=(1, 2))
        assert [e.to_dict() for e in tobs.events_from_metrics(m, **kw)] \
            == [e.to_dict() for e in jobs.events_from_metrics(m, **kw)]


# ------------------------------ metrics -------------------------------------

def _registry_calls(rng, n=60):
    calls = []
    for _ in range(n):
        kind = str(rng.choice(["counter", "gauge", "gauge_inc", "hist"]))
        name = {"counter": "repro_c_total", "gauge": "repro_g",
                "gauge_inc": "repro_g", "hist": "repro_h_ms"}[kind]
        labels = {"op": str(rng.choice(["q", 'q"x', "a\\b", "new\nline"])),
                  "lane": str(int(rng.integers(3)))}
        value = float(np.round(rng.random() * 600, 3))
        if kind == "counter":
            value = float(rng.integers(0, 5))
        calls.append((kind, name, labels, value))
    return calls


def _apply(pkg, calls):
    reg = pkg.MetricsRegistry()
    for kind, name, labels, value in calls:
        if kind == "counter":
            reg.counter(name, "help").inc(value, **labels)
        elif kind == "gauge":
            reg.gauge(name, "help").set(value, **labels)
        elif kind == "gauge_inc":
            reg.gauge(name, "help").inc(value - 300.0, **labels)
        else:
            reg.histogram(name, "help").observe(value, **labels)
    return reg


@pytest.mark.parametrize("seed", range(4))
def test_prometheus_text_and_json_equal_line_for_line(seed, tmp_path):
    calls = _registry_calls(np.random.default_rng(seed))
    t, j = _apply(tobs, calls), _apply(jobs, calls)
    assert t.to_prometheus().splitlines() == j.to_prometheus().splitlines()
    assert t.to_json() == j.to_json()
    tp = t.write_prometheus(str(tmp_path / "t.prom"))
    jp = j.write_prometheus(str(tmp_path / "j.prom"))
    assert open(tp).read() == open(jp).read()


def test_histogram_edges_gauges_and_type_guards_as_jax():
    out = []
    for pkg in (tobs, jobs):
        reg = pkg.MetricsRegistry()
        h = reg.histogram("h_ms", buckets=(10.0, 1.0))
        for v in (1.0, 10.0, 10.0000001, 0.5):
            h.observe(v, kind="d")
        g = reg.gauge("g")
        g.set(3, lane="0")
        g.set(1, lane="0")
        g.inc(-3, lane="1")
        with pytest.raises(TypeError):
            reg.gauge("h_ms")
        with pytest.raises(ValueError):
            reg.counter("c_total").inc(-1)
        assert reg.get("missing") is None
        out.append((reg.to_prometheus(), h.buckets, h.count(kind="d")))
    assert out[0] == out[1]
    assert out[0][1] == (1.0, 10.0) and out[0][2] == 4


# ------------------------------- tracer -------------------------------------

def test_chrome_trace_equal_on_a_fixed_clock(tmp_path):
    traces = []
    for pkg in (tobs, jobs):
        ticks = iter(np.arange(0.0, 10.0, 0.125))
        tr = pkg.Tracer(clock=lambda: float(next(ticks)))
        with tr.span("build", cat="campaign", cell="c1"):
            pass
        tr.add_span("decode", cat="serving", start_s=1.0, dur_s=0.5,
                    step=3)
        tr.add_span("neg", cat="serving", start_s=2.0, dur_s=-1.0)
        traces.append((tr.to_chrome_trace(), tr.total_s("serving"),
                       len(tr)))
        json.load(open(tr.write(str(tmp_path / f"{pkg.__name__}.json"))))
    assert traces[0] == traces[1]
    events = [e for e in traces[0][0]["traceEvents"] if e["ph"] == "X"]
    assert {e["name"] for e in events} == {"build", "decode", "neg"}


# --------------------------- bundle + replay --------------------------------

def _observe_steps(pkg, rt, seed):
    """A seeded run of step summaries through ``observe_metrics`` (with
    request attribution and lane attrs), injections and cell events with
    their live incs, as the engine and the soak publishers pair them."""
    rng = np.random.default_rng(seed)
    obs = pkg.Observability.create()
    for step in range(30):
        m = _metrics_dict(rng)
        rt.observe_metrics(m, source="serving.engine", step=step,
                           t_s=0.01 * step, obs=obs,
                           request_ids=(step, step + 1),
                           attrs={"kind": "decode", "lane": "lane0",
                                  "tenants": ["a"]})
        if rng.random() < 0.2:
            obs.registry.counter("repro_injections_total").inc(
                1, source="serving.engine")
            obs.bus.emit(pkg.FaultEvent(op="layers.mlp.down", step=step,
                                        source="serving.engine",
                                        kind="injection"))
    obs.registry.counter("repro_detections_total").inc(3, cell="c1")
    obs.registry.counter("repro_injections_total").inc(4, cell="c1")
    obs.registry.counter("repro_escapes_total").inc(1, cell="c1")
    obs.registry.counter("repro_false_positives_total").inc(0, cell="c1")
    obs.bus.emit(pkg.FaultEvent(
        op="soak", step=0, source="serving.soak", kind="cell",
        cell_id="c1", errors=3, checks=4,
        attrs={"effective_detected": 3, "escapes": 1,
               "false_positives": 0}))
    return obs


@pytest.mark.parametrize("seed", [0, 5])
def test_observe_metrics_and_replay_equal_jax(tmp_path, seed):
    t = _observe_steps(tobs, trt, seed)
    j = _observe_steps(jobs, jrt, seed)
    assert [e.to_dict() for e in t.bus] == [e.to_dict() for e in j.bus]
    assert t.registry.to_prometheus() == j.registry.to_prometheus()
    tpaths = t.write(str(tmp_path / "t"))
    jpaths = j.write(str(tmp_path / "j"))
    assert set(tpaths) == {"events", "trace", "prometheus", "metrics_json"}
    assert open(tpaths["events"]).read() == open(jpaths["events"]).read()
    for line in open(tpaths["events"]):
        jobs.validate_event(tobs.validate_event(json.loads(line)))
    # replay of either package's JSONL, by either package, gives the live
    # fault-pipeline lines
    for paths in (tpaths, jpaths):
        for pkg in (tobs, jobs):
            assert mirrored_lines(pkg.replay(paths["events"])) == \
                mirrored_lines(t.registry)
    assert mirrored_lines(t.registry)


def test_incremental_flush_is_crash_durable(tmp_path):
    obs = tobs.Observability.create()
    obs.bus.emit(tobs.FaultEvent(op="qgemm", step=0, source="t"))
    paths = obs.open_incremental(str(tmp_path), every=3)
    for i in range(1, 8):
        obs.registry.counter("repro_detections_total").inc(1, op="q")
        obs.bus.emit(tobs.FaultEvent(op="qgemm", step=i, source="t",
                                     errors=1))
        # every event is on disk already (no final write)
        lines = open(paths["events"]).read().splitlines()
        assert len(lines) == i + 1
    snap = json.load(open(paths["metrics_json"]))
    assert snap["repro_detections_total"]["samples"][0]["value"] == 6.0
    final = obs.write(str(tmp_path))
    assert len(open(final["events"]).read().splitlines()) == 8


# ------------------------- the engine's paging events -----------------------

def test_paged_engine_lifecycle_events_equal_jax(tmp_path):
    """The paged lanes' admit / scrub_cache / evict_corrupt / rebuild
    events, spans and ``repro_paging_ops_total``, with a KV page flip on
    a recompute lane, every arrival at t = 0: the port's event stream
    equals the JAX engine's (run op by op) field for field, times and
    step durations aside, and replay mirrors the live counters."""
    from repro.configs import reduce_cfg
    from repro.configs.registry import get_arch
    from repro.paging import PagingConfig as JPaging
    from repro.protect import ProtectionPlan as JPlan
    from repro.serving import (FaultInjection as JInj,
                               ServingEngine as JEngine, TenantSpec as JT,
                               chat_stream)
    from repro_torch.configs import get_arch as t_arch, reduce_cfg as t_red
    from repro_torch.models.convert import from_jax
    from repro_torch.paging import PagingConfig as TPaging
    from repro_torch.protect import ProtectionPlan as TPlan
    from repro_torch.serving import (FaultInjection as TInj,
                                     ServingEngine as TEngine,
                                     TenantSpec as TT)

    text = "*:policy=recompute,kv_cache_paged:on"
    kw = dict(n_slots=2, max_prompt=32, max_new_tokens=8, seed=0)
    je = JEngine(reduce_cfg(get_arch("llama3.2-1b")),
                 [JT("a", JPlan.parse(text, name="paged-fix"))],
                 paging=JPaging(page_size=8, n_pages=32), **kw)
    te = TEngine(t_red(t_arch("llama3.2-1b")),
                 [TT("a", TPlan.parse(text, name="paged-fix"))],
                 paging=TPaging(page_size=8, n_pages=32), device="cpu",
                 **kw)
    te.params = from_jax(jax.tree.map(np.asarray, je.params), device="cpu")
    stream = [dataclasses.replace(r, arrival_s=0.0) for r in chat_stream(
        6, tenants={"a": 1.0}, rate_rps=200.0, seed=3, mean_prompt=24,
        max_prompt=32, mean_output=6, max_output=8, prefix_len=16,
        prefix_seed=77)]
    jo, to = jobs.Observability.create(), tobs.Observability.create()
    with jax.disable_jit():
        jt = je.run(stream, obs=jo, inject=[JInj(
            step=5, target="kv", persistent=True, seed=7)])
    tt = te.run(stream, obs=to, inject=[TInj(
        step=5, target="kv", persistent=True, seed=7)])
    assert tt.summary()["faults"]["injections_detected"] == 1
    assert jt.summary()["faults"]["injections_detected"] == 1
    assert _untimed(to.bus) == _untimed(jo.bus)
    assert _untimed_registry(to.registry) == _untimed_registry(jo.registry)
    actions = [e.attrs["action"] for e in to.bus
               if e.kind == "info" and e.attrs.get("channel") == "paging"]
    for want in ("admit", "scrub_cache", "evict_corrupt", "rebuild"):
        assert want in actions, actions
    assert {"paged_admit", "paged_scrub_cache", "paged_rebuild"} <= \
        {s.name for s in to.tracer.spans}
    assert [(s.name, s.cat) for s in to.tracer.spans] == \
        [(s.name, s.cat) for s in jo.tracer.spans]
    paths = to.write(str(tmp_path))
    assert mirrored_lines(tobs.replay(paths["events"])) == \
        mirrored_lines(to.registry)


def _untimed(bus):
    """Every event field but the times: ``t_s``, a step's and a paging
    span's duration."""
    out = []
    for e in bus:
        d = e.to_dict()
        d.pop("t_s")
        d["attrs"] = {k: v for k, v in d["attrs"].items()
                      if k not in ("duration_ms", "dur_s")}
        out.append(d)
    return out


def _untimed_registry(registry):
    """The Prometheus lines but the step-duration histogram's."""
    return [ln for ln in registry.to_prometheus().splitlines()
            if "repro_step_duration_ms" not in ln]


# ------------------------------ the serve CLI -------------------------------

def test_serve_cli_monitor_obs_dir_writes_four_files(tmp_path):
    from repro_torch.launch import serve

    out = tmp_path / "obs"
    assert serve.main(["--arch", "llama3.2-1b", "--device", "cpu",
                       "--smoke", "--requests", "6", "--monitor",
                       "--obs-dir", str(out), "--obs-flush-every", "5",
                       "--inject-step", "2",
                       "--inject-victim", "mlp.down"]) == 0
    names = sorted(p.name for p in out.iterdir())
    assert names == ["obs_events.jsonl", "obs_metrics.json",
                     "obs_metrics.prom", "obs_trace.json"]
    bus = jobs.EventBus.from_jsonl(str(out / "obs_events.jsonl"))
    assert any(e.kind == "injection" for e in bus)
    assert any(e.kind == "detection" and e.op == "qgemm" for e in bus)
    json.load(open(out / "obs_trace.json"))
    prom = (out / "obs_metrics.prom").read_text()
    assert "repro_abft_checks_total" in prom
