"""The port's fault-tolerant training loop (``repro_torch.runtime``)
against the JAX package's (``repro.runtime``), on the CPU, over the fake
step functions of ``tests/test_substrate.py``, ``tests/test_monitor.py``
and ``tests/test_adapt.py``: the loop stats, the resumed steps, the
final state, the obs events (times aside), the monitor's ticks,
estimates and health, and the adaptive controller's moves and the
step-function rebinding equal JAX's.  The port resumes from a checkpoint
the JAX loop wrote.  The straggler monitor and ``_errors_in`` (the
legacy-alias rule, ceiled fractions) are pure Python, equal on the same
inputs.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro import obs as jobs  # noqa: E402
from repro import adapt as jad  # noqa: E402
from repro.runtime import (LoopConfig as JConfig,  # noqa: E402
                           StragglerMonitor as JStraggler,
                           TrainLoop as JLoop)
from repro_torch import adapt as tad  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.runtime import (LoopConfig, StragglerMonitor,  # noqa: E402
                                 TrainLoop, metrics_to_host)

from test_torch_obs import _untimed  # noqa: E402


class JDS:
    def batch_at(self, step):
        rng = np.random.default_rng(step)
        return {"x": jnp.asarray(rng.standard_normal(8), jnp.float32)}


class TDS:
    def batch_at(self, step):
        rng = np.random.default_rng(step)
        return {"x": rng.standard_normal(8).astype(np.float32)}


def _steps(fault_step=3, key="abft/gemm_errors", times=1):
    """The substrate test's quadratic step, for each package: a detected
    soft error at ``fault_step`` on its first ``times`` tries."""
    calls = {"j": 0, "t": 0}

    def j_step(state, batch):
        w = state["w"] - 0.1 * (state["w"] - batch["x"].mean())
        faulty = int(state["step"]) == fault_step and calls["j"] < times
        calls["j"] += faulty
        m = {key: jnp.asarray(1 if faulty else 0, jnp.int32),
             "loss": jnp.mean((w - batch["x"].mean()) ** 2)}
        return {"w": w, "step": state["step"] + 1}, m

    def t_step(state, batch):
        w = state["w"] - 0.1 * (state["w"] - batch["x"].mean())
        faulty = int(state["step"]) == fault_step and calls["t"] < times
        calls["t"] += faulty
        m = {key: torch.tensor(1 if faulty else 0, dtype=torch.int32),
             "loss": torch.mean((w - batch["x"].mean()) ** 2)}
        return {"w": w, "step": state["step"] + 1}, m

    return j_step, t_step


def _j0():
    return {"w": jnp.zeros(()), "step": jnp.zeros((), jnp.int32)}


def _t0():
    return {"w": torch.zeros(()), "step": torch.zeros((), dtype=torch.int32)}


def _cfgs(tmp_path, **kw):
    base = dict(save_every=2, log_every=100, **kw)
    return (JConfig(ckpt_dir=str(tmp_path / "j"), **base),
            LoopConfig(ckpt_dir=str(tmp_path / "t"), **base))


@pytest.mark.parametrize("policy", ["recompute", "log", "restore"])
def test_loop_runs_resumes_and_acts_as_jax(tmp_path, policy):
    """A fault at step 3: stats, final step and w equal JAX's under each
    policy; a new loop resumes from the committed step and runs on."""
    j_step, t_step = _steps()
    jc, tc = _cfgs(tmp_path, fault_policy=policy)
    jl, tl = JLoop(j_step, JDS(), cfg=jc), TrainLoop(t_step, TDS(), cfg=tc)
    js, jm = jl.run(_j0(), 6)
    ts, tm = tl.run(_t0(), 6)
    assert tl.stats == jl.stats
    assert int(ts["step"]) == int(js["step"]) == 6
    np.testing.assert_allclose(float(ts["w"]), float(js["w"]), rtol=1e-6)
    assert set(tm) == set(jm)
    assert isinstance(tm["loss"], float)
    # "crash": new loops resume from committed step 6 and run to 8
    js2, _ = JLoop(j_step, JDS(), cfg=jc).run(_j0(), 8)
    ts2, _ = TrainLoop(t_step, TDS(), cfg=tc).run(_t0(), 8)
    assert int(ts2["step"]) == int(js2["step"]) == 8
    np.testing.assert_allclose(float(ts2["w"]), float(js2["w"]), rtol=1e-6)


def test_recompute_that_stays_faulty_is_logged(tmp_path):
    j_step, t_step = _steps(times=5)
    jc, tc = _cfgs(tmp_path, fault_policy="recompute")
    jl, tl = JLoop(j_step, JDS(), cfg=jc), TrainLoop(t_step, TDS(), cfg=tc)
    jl.run(_j0(), 5)
    tl.run(_t0(), 5)
    assert tl.stats == jl.stats == {"recomputes": 1, "restores": 0,
                                    "faulty_steps": 1}


def test_port_resumes_from_the_jax_loops_checkpoint(tmp_path):
    j_step, t_step = _steps()
    cfg = dict(save_every=2, log_every=100)
    JLoop(j_step, JDS(), cfg=JConfig(ckpt_dir=str(tmp_path), **cfg)).run(
        _j0(), 6)
    tl = TrainLoop(t_step, TDS(), cfg=LoopConfig(ckpt_dir=str(tmp_path),
                                                 **cfg))
    seen = []
    tl.metrics_hook = lambda s, m: seen.append(s)
    tl.cfg.log_every = 1
    ts, _ = tl.run(_t0(), 8)
    assert seen == [7, 8]                   # steps 6 and 7 only
    assert int(ts["step"]) == 8


@pytest.mark.parametrize("metrics,want", [
    ({"abft/gemm_errors": 1, "abft/qgemm_errors": 0}, 0),
    ({"abft/gemm_errors": 2}, 2),
    ({"abft/qgemm_errors": 0.25, "abft/float_gemm_errors": 0.5,
      "abft/gemm_errors": 0.75, "comm/errors": 0.25}, 1),
    ({"abft/eb_errors": 1, "comm/errors": 1}, 2),
    ({"loss": 3.0}, 0),
])
def test_errors_in_alias_rule_and_ceil(tmp_path, metrics, want):
    jl = JLoop(lambda s, b: (s, {}), None,
               cfg=JConfig(ckpt_dir=str(tmp_path / "j")))
    tl = TrainLoop(lambda s, b: (s, {}), None,
                   cfg=LoopConfig(ckpt_dir=str(tmp_path / "t")))
    host = metrics_to_host({k: torch.tensor(v) for k, v in metrics.items()})
    assert jl._errors_in({k: jnp.asarray(v) for k, v in metrics.items()}) \
        == tl._errors_in(host) == want


def test_metrics_to_host_keeps_numbers():
    host = metrics_to_host({"a": torch.tensor(3, dtype=torch.int32),
                            "b": torch.tensor(0.25), "c": 7})
    assert host == {"a": 3.0, "b": 0.25, "c": 7}


def test_straggler_monitor_equal():
    rng = np.random.default_rng(0)
    dts = np.concatenate([rng.uniform(0.9, 1.1, 30), [5.0, 5.0, 5.0, 1.0],
                          rng.uniform(0.9, 1.1, 10), [9.0]])
    fired = {"j": [], "t": []}
    jm = JStraggler(window=20, patience=2,
                    on_straggler=lambda e: fired["j"].append(e["step"]))
    tm = StragglerMonitor(window=20, patience=2,
                          on_straggler=lambda e: fired["t"].append(e["step"]))
    hosts = {0: 1.0, 1: 1.1, 2: 4.0}
    for i, dt in enumerate(dts):
        assert jm.observe(i, float(dt), hosts) == tm.observe(i, float(dt),
                                                            hosts)
    assert fired["j"] == fired["t"] and fired["t"]
    assert jm.summary() == tm.summary()


def test_loop_publishes_into_the_monitor_as_jax(tmp_path):
    """tests/test_monitor.py's train-loop case on both packages."""
    j_step, t_step = _steps()
    jc, tc = _cfgs(tmp_path, fault_policy="recompute")
    jmon, tmon = jobs.Monitor(), tobs.Monitor()
    jl = JLoop(j_step, JDS(), cfg=jc, monitor=jmon)
    tl = TrainLoop(t_step, TDS(), cfg=tc, monitor=tmon)
    jl.run(_j0(), 6)
    tl.run(_t0(), 6)
    assert tmon.summary()["ticks"] == jmon.summary()["ticks"] == 6
    assert tmon.estimate(op="gemm")["errors"] == \
        jmon.estimate(op="gemm")["errors"] == 1
    assert not tmon.active_alerts() and not jmon.active_alerts()
    assert tmon.summary()["health"] == jmon.summary()["health"] == {}
    assert _untimed(tl.obs.bus) == _untimed(jl.obs.bus)
    assert any(e.kind == "detection" for e in tl.obs.bus)
    spans = [s for s in tl.obs.tracer.spans if s.name == "train_step"]
    assert len(spans) == 6


def test_loop_requires_monitor_for_adapt(tmp_path):
    with pytest.raises(ValueError, match="monitor"):
        TrainLoop(lambda s, b: (s, {}), None,
                  cfg=LoopConfig(ckpt_dir=str(tmp_path)),
                  adapt=tad.AdaptiveThresholds())


def test_loop_ticks_controllers_and_rebinds_step_fn_as_jax(tmp_path):
    """tests/test_adapt.py's train-loop case on both packages: a clean
    stream flagging 8 of 100 checks overruns a 2% budget; the controller
    loosens the bound, the moves reach ``on_threshold`` and the bus."""
    def j_step(state, batch):
        m = {"abft/embedding_bag_errors": jnp.asarray(8, jnp.int32),
             "abft/embedding_bag_checks": jnp.asarray(100, jnp.int32)}
        return {"w": state["w"] + jnp.mean(batch["x"])}, m

    def t_step(state, batch):
        m = {"abft/embedding_bag_errors": torch.tensor(8, dtype=torch.int32),
             "abft/embedding_bag_checks": torch.tensor(100,
                                                       dtype=torch.int32)}
        return {"w": state["w"] + torch.mean(batch["x"])}, m

    runs = {}
    for name, mod, obs_mod, loop_cls, cfg_cls, step, ds, w0 in (
            ("j", jad, jobs, JLoop, JConfig, j_step, JDS(),
             {"w": jnp.zeros(())}),
            ("t", tad, tobs, TrainLoop, LoopConfig, t_step, TDS(),
             {"w": torch.zeros(())})):
        mon = obs_mod.Monitor(rules=())
        ad = mod.AdaptiveThresholds(config=mod.ControllerConfig(
            fp_budget=0.02, min_checks=50, cooldown_ticks=0))
        ad.manage("embedding_bag", "*", rel_bound=1e-5)
        seen = []

        def on_threshold(moved, seen=seen, step=step):
            seen.append(dict(moved))
            return step

        loop = loop_cls(step, ds,
                        cfg=cfg_cls(ckpt_dir=str(tmp_path / name),
                                    fault_policy="log", save_every=100),
                        monitor=mon, adapt=ad, on_threshold=on_threshold)
        loop.run(w0, 6, resume=False)
        runs[name] = (ad, seen, loop)
    (jad_, jseen, jloop), (tad_, tseen, tloop) = runs["j"], runs["t"]
    jctrl = jad_.controllers[("embedding_bag", "*")]
    tctrl = tad_.controllers[("embedding_bag", "*")]
    assert tctrl.adjustments == jctrl.adjustments >= 1
    assert tctrl.rel_bound == jctrl.rel_bound > 1e-5
    assert tseen == jseen and tseen
    assert tad_.summary() == jad_.summary()
    assert _untimed(tloop.obs.bus) == _untimed(jloop.obs.bus)
    assert any(e.kind == "threshold" for e in tloop.obs.bus)
    assert tloop.stats == jloop.stats == {"recomputes": 0, "restores": 0,
                                          "faulty_steps": 6}
