"""The port's adaptive thresholds (``repro_torch.adapt``), the engine's
adaptive hooks and ``--grid adaptive`` (``repro_torch.campaign.adaptive``)
against the JAX package, on the CPU.

* The controllers, the variance model and ``calibrate_from_sweep`` are
  pure Python: the same estimate and residual streams (numpy, fixed
  seeds) give the same moves, bounds and ``summary()`` exactly.  The
  JAX package's property tests draw fresh seeds each run; here they take
  fixed ones.
* The grid's ratio stream draws JAX's own Threefry stream
  (``repro_torch.campaign.prng``): keys, tables, bags and flips equal
  ``jax.random``'s bit for bit.  On dyadic scales (α, β powers of two)
  the float32 ratios of the same bags equal JAX's exactly; on random
  scales the order of the sums decides the last bits (the 512-term
  bag sum is not in XLA's order), so the clean-flag rate is held by
  Wilson overlap at bounds above the float32 round-off, and in
  bfloat16 the clean-ratio median and p99 within a factor of 2.
* The grid itself: its cell gates, detection by Wilson overlap with the
  JAX CLI's artifact committed under ``src/repro_torch/campaign/
  baselines/`` and with ``benchmarks/baselines/BENCH_campaign_adaptive_
  quick.json``, and the differ against the JAX CLI's artifact with 0
  regressions.  At the float32 round-off cliff, where the f32 cells
  converge (~1.1e-7), the clean-flag rate is the sums' order's (ROADMAP
  §C2, §C8): it is held by the differ, not by Wilson overlap.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.adapt as jad  # noqa: E402
import repro_torch.adapt as tad  # noqa: E402
from repro import obs as jobs  # noqa: E402
from repro.campaign import adaptive as jgrid  # noqa: E402
from repro_torch import obs as tobs  # noqa: E402
from repro_torch.campaign import adaptive as tgrid  # noqa: E402
from repro_torch.campaign.diff import (diff_artifacts,  # noqa: E402
                                       wilson_gate)
from repro_torch.obs.monitor import wilson_interval  # noqa: E402

from test_torch_obs import _untimed  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
THRESHOLDS = ROOT / "benchmarks" / "baselines" / \
    "BENCH_campaign_thresholds.json"
BASELINE = ROOT / "benchmarks" / "baselines" / \
    "BENCH_campaign_adaptive_quick.json"
JAX_NOW = ROOT / "src" / "repro_torch" / "campaign" / "baselines" / \
    "BENCH_campaign_adaptive_quick.json"


# ------------------------------ controllers ---------------------------------

@pytest.mark.parametrize("kw", [
    dict(fp_budget=0.0), dict(fp_budget=1.0), dict(floor=1e-2, ceiling=1e-5),
    dict(step=1.0), dict(hysteresis=0.0), dict(floor=0.0)])
def test_controller_config_validation_as_jax(kw):
    msgs = []
    for pkg in (tad, jad):
        with pytest.raises(ValueError) as ei:
            pkg.ControllerConfig(**kw)
        msgs.append(str(ei.value))
    assert msgs[0] == msgs[1]
    assert tad.ControllerConfig() == tad.ControllerConfig(
        **dataclasses.asdict(jad.ControllerConfig()))


@pytest.mark.parametrize("seed", range(4))
def test_variance_model_equals_jax(seed):
    rng = np.random.default_rng(seed)
    models = [(pkg.VarianceModel(decay=0.97), pkg) for pkg in (tad, jad)]
    for _ in range(6):
        res = list(np.abs(rng.normal(0, 10 ** rng.uniform(-7, -2), 50)))
        mags = list(rng.uniform(0.1, 300.0, 50)) if rng.random() < 0.5 \
            else None
        outs = []
        for m, _ in models:
            m.observe(res, mags)
            outs.append((m.count, m.mean, m.std, m.mag_mean,
                         m.rel_bound(0.01, floor=1e-9),
                         m.rel_bound(0.2, ceiling=1e-3)))
        assert outs[0] == outs[1]
    for pkg in (tad, jad):
        with pytest.raises(ValueError):
            pkg.VarianceModel(decay=1.0)
        with pytest.raises(ValueError):
            pkg.VarianceModel().rel_bound(0.01)


def _estimate(rng, checks):
    k = int(rng.binomial(checks, 10 ** rng.uniform(-4, -0.5)))
    lo, hi = wilson_interval(k, checks)
    return {"samples": checks, "checks": checks, "errors": k,
            "flag_rate": k / checks if checks else 0.0,
            "flag_rate_low": lo, "flag_rate_high": hi}


@pytest.mark.parametrize("seed", range(6))
def test_controller_moves_equal_jax_on_seeded_estimates(seed):
    """Adversarial estimate streams (thin evidence, overruns, quiet
    stretches): every tick's move, every bound and the summaries equal;
    each move is one multiplicative step inside [floor, ceiling], spaced
    by the cooldown."""
    rng = np.random.default_rng(seed)
    cfg = dict(fp_budget=float(rng.choice([0.005, 0.02, 0.1])),
               min_checks=int(rng.integers(1, 200)),
               cooldown_ticks=int(rng.integers(0, 4)),
               settle_ticks=int(rng.integers(1, 10)),
               window_ticks=int(rng.integers(4, 40)))
    ctrls = [pkg.ThresholdController(
        "embedding_bag", "t", rel_bound=1e-5,
        config=pkg.ControllerConfig(**cfg)) for pkg in (tad, jad)]
    last_move, prev = None, 1e-5
    for i in range(300):
        est = _estimate(rng, int(rng.integers(0, 600)))
        outs = [(c.evidence_window(), c.tick(est)) for c in ctrls]
        assert outs[0] == outs[1]
        moved = outs[0][1]
        if moved is not None:
            c = ctrls[0]
            assert c.config.floor <= moved <= c.config.ceiling
            ratio = max(moved, prev) / min(moved, prev)
            assert ratio == pytest.approx(c.config.step) or \
                moved in (c.config.floor, c.config.ceiling)
            if last_move is not None:
                assert i - last_move > c.config.cooldown_ticks
            last_move, prev = i, moved
    assert ctrls[0].summary() == ctrls[1].summary()


@pytest.mark.parametrize("floor", [1e-8, 1e-7])
def test_zero_fp_stream_walks_to_the_floor_and_stays(floor):
    outs = []
    for pkg in (tad, jad):
        c = pkg.ThresholdController(
            "eb", rel_bound=1e-4, config=pkg.ControllerConfig(
                fp_budget=0.05, floor=floor, min_checks=1,
                cooldown_ticks=1))
        lo, hi = wilson_interval(0, 512)
        bounds = []
        for _ in range(200):
            c.tick({"checks": 512, "errors": 0, "flag_rate": 0.0,
                    "flag_rate_low": lo, "flag_rate_high": hi})
            bounds.append(c.rel_bound)
        outs.append((bounds, c.summary()))
    assert outs[0] == outs[1]
    bounds = outs[0][0]
    assert all(b2 <= b1 for b1, b2 in zip(bounds, bounds[1:]))
    assert bounds[-1] == floor and outs[0][1]["converged"]


@pytest.mark.parametrize("cliff", [3e-7, 2e-6, 5e-5])
def test_budget_monotonicity_on_a_cliff(cliff):
    """A steplike fp(bound) environment: a bigger budget never converges
    to a looser bound, and both packages land on the same bound."""
    def run(pkg, budget):
        c = pkg.ThresholdController("eb", rel_bound=1e-5,
                                    config=pkg.ControllerConfig(
                                        fp_budget=budget, min_checks=1,
                                        cooldown_ticks=1))
        for _ in range(400):
            k = 300 if c.rel_bound < cliff else 0
            lo, hi = wilson_interval(k, 512)
            c.tick({"checks": 512, "errors": k, "flag_rate": k / 512,
                    "flag_rate_low": lo, "flag_rate_high": hi})
        return c.rel_bound
    finals = {}
    for budget in (0.005, 0.02, 0.1):
        finals[budget] = run(tad, budget)
        assert finals[budget] == run(jad, budget)
        assert finals[budget] >= cliff
    assert finals[0.1] <= finals[0.02] <= finals[0.005]


def _drive(pkg, n_ticks=40, seed=0):
    rng = np.random.default_rng(seed)
    obs = pkg.Observability.create()
    mon = pkg.Monitor(rules=())
    adapt_mod = tad if pkg is tobs else jad
    ad = adapt_mod.AdaptiveThresholds(config=adapt_mod.ControllerConfig(
        fp_budget=0.02, min_checks=10, cooldown_ticks=0),
        obs=obs, source="test.adapt")
    ad.manage("embedding_bag", "premium", rel_bound=1e-5)
    ad.manage("qgemm", "premium")
    ad.manage("embedding_bag", "batch", rel_bound=3e-6)
    for i in range(n_ticks):
        k = int(rng.integers(0, 60)) if i < n_ticks // 2 else 0
        mon.record_step(float(i), {"embedding_bag": (200, k),
                                   "qgemm": (50, 0)},
                        tenants=("premium", "batch"))
        ad.tick(mon, t_s=float(i), step=i)
    return obs, ad


def test_threshold_events_summary_and_replay_equal_jax(tmp_path):
    (to, tadp), (jo, jadp) = _drive(tobs), _drive(jobs)
    assert [e.to_dict() for e in to.bus] == [e.to_dict() for e in jo.bus]
    assert tadp.summary() == jadp.summary()
    assert to.registry.to_prometheus() == jo.registry.to_prometheus()
    moves = [e for e in to.bus if e.kind == "threshold"]
    assert {e.attrs["direction"] for e in moves} == {"raise", "lower"}
    path = to.bus.to_jsonl(str(tmp_path / "ev.jsonl"))
    fams = ("repro_threshold_adjustments_total", "repro_threshold_rel_bound")

    def lines(reg):
        return sorted(ln for ln in reg.to_prometheus().splitlines()
                      if ln.startswith(fams))
    for pkg in (tobs, jobs):
        assert lines(pkg.replay(path)) == lines(to.registry)
    assert lines(to.registry)


def test_op_default_bound_is_the_jax_one():
    for op in ("embedding_bag", "qgemm", "kv_cache", "float_gemm"):
        assert tad._op_default_bound(op) == jad._op_default_bound(op)


@pytest.mark.parametrize("budget", [1e-9, 1e-3, 0.01, 0.05, 0.3])
def test_calibrate_from_sweep_equals_jax(budget):
    art = json.loads(THRESHOLDS.read_text())
    for band in ("*", "low", "significant", "all"):
        try:
            want = jad.calibrate_from_sweep(art, fp_budget=budget, band=band)
        except ValueError:
            with pytest.raises(ValueError):
                tad.calibrate_from_sweep(art, fp_budget=budget, band=band)
            continue
        assert tad.calibrate_from_sweep(str(THRESHOLDS), fp_budget=budget,
                                        band=band) == want


# ------------------------------ the grid's ratios ---------------------------

SHAPE = (128, 16, 64, 32)


@pytest.mark.parametrize("seed", [0, 1, 2**33 + 5])
def test_prng_draws_equal_jax(seed):
    from repro_torch.campaign import prng
    k, kn = jax.random.key(seed), prng.key(seed)
    np.testing.assert_array_equal(np.asarray(jax.random.key_data(k)), kn)
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(jax.random.split(k, 5))),
        prng.split(kn, 5))
    for data in (0, 7, 2**31 + 3):
        np.testing.assert_array_equal(
            np.asarray(jax.random.key_data(jax.random.fold_in(k, data))),
            prng.fold_in(kn, data))
    for shape, lo, hi, jdt, ndt in (((128, 16), -127, 128, jnp.int8,
                                     np.int8),
                                    ((64, 32), 0, 128, jnp.int32, np.int32),
                                    ((), 0, 7, jnp.int32, np.int32),
                                    ((33,), -5, 1000, jnp.int32, np.int32)):
        want = np.asarray(jax.random.randint(k, shape, lo, hi, jdt))
        got = prng.randint(kn, shape, lo, hi, ndt)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    for lo, hi in ((0.01, 0.02), (0.3, 0.7)):
        np.testing.assert_array_equal(
            prng.uniform(kn, (257,), lo, hi),
            np.asarray(jax.random.uniform(k, (257,), jnp.float32, lo, hi)))


@pytest.mark.parametrize("drift", ["variance_shift", "prompt_mix"])
def test_cell_draws_are_the_jax_cells_draws(drift):
    """A cell's table and each batch's bags and flip are the JAX cell's:
    the trial ratios, with the flip replayed from JAX's draws, flag the
    same trials at bounds well above the float32 round-off."""
    from repro_torch.campaign import prng
    seed = 3
    jstate = jgrid._regime(jax.random.key(seed), SHAPE)
    tstate = tgrid.regime(prng.key(seed), SHAPE, "cpu")
    for name in ("table", "alphas", "betas", "rowsums"):
        np.testing.assert_array_equal(tstate[name].numpy(),
                                      np.asarray(jstate[name]))
    (nv, _), (nv_b, dt_b) = jgrid._drift_regimes(drift, SHAPE)
    (_, _), (_, tdt_b) = tgrid.drift_regimes(drift, SHAPE)
    _, jtrial = jgrid._ratio_fns(SHAPE, nv_b, dt_b)
    stream = tgrid.RatioStream(tstate, SHAPE, nv_b, tdt_b, "cpu")
    base, jbase = prng.key(seed + 1), jax.random.key(seed + 1)
    bounds = (3e-3, 1e-3) if drift == "variance_shift" else (1e-5, 1e-6)
    for i in range(24):
        k = prng.fold_in(base, 2 * i + 1)
        jk = jax.random.fold_in(jbase, 2 * i + 1)
        ki = prng.split(k, 5)[0]
        np.testing.assert_array_equal(
            tgrid.draw_bags(ki, SHAPE, nv_b).numpy()[:, :nv_b],
            np.asarray(jax.random.randint(jax.random.split(jk, 5)[0],
                                          (SHAPE[2], nv_b), 0, SHAPE[0],
                                          jnp.int32)))
        got = stream.trial(k)
        want = np.asarray(jtrial(jstate, jk)[0], np.float64)
        for b in bounds:
            assert bool(np.any(got > b)) == bool(np.any(want > b)), (i, b)
    np.testing.assert_array_equal(tstate["table"].numpy(),
                                  np.asarray(jstate["table"]))


def test_clean_flag_rate_above_round_off_overlaps_jax():
    """The same bags' clean-flag rates at static bounds above the
    float32 round-off (bfloat16 sums; float32 at 2e-7, two ulps of a
    bag's magnitude) overlap JAX's in Wilson intervals."""
    from repro_torch.campaign import prng
    jstate = jgrid._regime(jax.random.key(0), SHAPE)
    tstate = tgrid.regime(prng.key(0), SHAPE, "cpu")
    for jdt, tdt, bounds in ((jnp.bfloat16, torch.bfloat16, (1e-3, 2e-3)),
                             (jnp.float32, torch.float32, (2e-7,))):
        jclean, _ = jgrid._ratio_fns(SHAPE, 32, jdt)
        stream = tgrid.RatioStream(tstate, SHAPE, 32, tdt, "cpu")
        got, want = [], []
        for i in range(60):
            got.append(stream.clean(prng.fold_in(prng.key(9), i)))
            want.append(np.asarray(jclean(
                jstate, jax.random.fold_in(jax.random.key(9), i)),
                np.float64))
        got, want = np.concatenate(got), np.concatenate(want)
        for b in bounds:
            a = wilson_interval(int(np.sum(got > b)), got.size)
            w = wilson_interval(int(np.sum(want > b)), want.size)
            assert max(a[0], w[0]) <= min(a[1], w[1]), (tdt, b, a, w)


def _jax_idx(key, n_valid):
    rows, _, bags, pool = SHAPE
    live = jax.random.randint(key, (bags, n_valid), 0, rows, jnp.int32)
    pad = jnp.full((bags, pool - n_valid), -1, jnp.int32)
    return torch.from_numpy(np.array(jnp.concatenate([live, pad], 1)))


def _dyadic_state(seed):
    from repro.core.abft_embedding import table_rowsums
    rng = np.random.default_rng(seed)
    rows, dim, _, _ = SHAPE
    table = rng.integers(-127, 128, (rows, dim)).astype(np.int8)
    alphas = (2.0 ** -rng.integers(5, 8, rows)).astype(np.float32)
    betas = (2.0 ** -rng.integers(1, 3, rows)).astype(np.float32)
    jstate = {"table": jnp.asarray(table), "alphas": jnp.asarray(alphas),
              "betas": jnp.asarray(betas)}
    jstate["rowsums"] = table_rowsums(jstate["table"])
    return jstate


def _torch_state(jstate):
    return {k: torch.from_numpy(np.asarray(v).copy())
            for k, v in jstate.items()}


@pytest.mark.parametrize("n_valid", [32, 8])
def test_f32_ratio_stream_equals_jax_on_dyadic_scales(n_valid):
    jstate = _dyadic_state(n_valid)
    tstate = _torch_state(jstate)
    clean, trial = jgrid._ratio_fns(SHAPE, n_valid, jnp.float32)
    _, dim, bags, _ = SHAPE
    for i in range(12):
        key = jax.random.fold_in(jax.random.key(11), i)
        idx = _jax_idx(key, n_valid)
        want = np.asarray(clean(jstate, key))
        got = tgrid.ratios(tstate, tstate["table"], idx, torch.float32)
        np.testing.assert_array_equal(got.numpy(), want)
        # the trial: JAX's draws, replayed into the port's flip
        ki, kb, kp, kc, kbit = jax.random.split(key, 5)
        draws = [int(jax.random.randint(k, (), 0, hi)) for k, hi in
                 ((kb, bags), (kp, n_valid), (kc, dim), (kbit, 8))]
        want_t, corrupted = trial(jstate, key)
        assert bool(corrupted)
        got_t = tgrid.trial_ratios(tstate, _jax_idx(ki, n_valid), *draws,
                                   torch.float32)
        np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
        assert np.any(np.asarray(want_t) > 0)
    # the table is left as it was
    np.testing.assert_array_equal(tstate["table"].numpy(),
                                  np.asarray(jstate["table"]))


def test_bf16_clean_ratios_within_a_factor_of_two_of_jax():
    """bfloat16 sums (the ``variance_shift`` drift): the order of the
    sums differs from XLA's, so the same bags' ratios are held by the
    clean-ratio median and p99, each within a factor of 2 of JAX's."""
    jstate = jgrid._regime(jax.random.key(0), SHAPE)
    tstate = _torch_state(jstate)
    clean, _ = jgrid._ratio_fns(SHAPE, 32, jnp.bfloat16)
    got, want = [], []
    for i in range(40):
        key = jax.random.fold_in(jax.random.key(1), i)
        want.append(np.asarray(clean(jstate, key), np.float64))
        got.append(tgrid.ratios(tstate, tstate["table"], _jax_idx(key, 32),
                                torch.bfloat16).numpy().astype(np.float64))
    got, want = np.concatenate(got), np.concatenate(want)
    for q in (0.5, 0.99):
        g, w = np.quantile(got, q), np.quantile(want, q)
        assert w > 1e-4 and 0.5 <= g / w <= 2.0, (q, g, w)


def test_specs_plans_and_schedules_are_the_jax_ones():
    for t_spec, j_spec in ((tgrid.quick_adaptive_spec(0),
                            jgrid.quick_adaptive_spec(0)),
                           (tgrid.full_adaptive_spec(3),
                            jgrid.full_adaptive_spec(3))):
        assert t_spec.to_dict() == j_spec.to_dict()
        assert t_spec.controller_config() == tad.ControllerConfig(
            **dataclasses.asdict(j_spec.controller_config()))
        assert [p.to_dict() for p in tgrid.adaptive_plans(t_spec)] == \
            [p.to_dict() for p in jgrid.adaptive_plans(j_spec)]
    for drift in tgrid.DRIFTS:
        assert tgrid.batches_per_tick(drift, 240, 2) == \
            jgrid._batches_per_tick(drift, 240, 2)
        (a, da), (b, db) = tgrid.drift_regimes(drift, SHAPE)
        (ja, jda), (jb, jdb) = jgrid._drift_regimes(drift, SHAPE)
        assert (a, b) == (ja, jb)
        assert (str(da), str(db)) == (f"torch.{jnp.dtype(jda).name}",
                                      f"torch.{jnp.dtype(jdb).name}")


def test_committed_jax_artifact_is_the_jax_cli_run():
    """The artifact the port's grid is gated against is what the
    unchanged JAX package computes here, cell for cell."""
    fresh = jgrid.run_adaptive_campaign(quick=True, seed=0)
    committed = json.loads(JAX_NOW.read_text())
    assert committed["env"]["jax"] == jax.__version__
    assert [c["cell_id"] for c in fresh["cells"]] == \
        [c["cell_id"] for c in committed["cells"]]
    for f, c in zip(fresh["cells"], committed["cells"]):
        assert json.loads(json.dumps(f["metrics"])) == c["metrics"]


def test_grid_adaptive_quick_on_cpu_passes_its_gates(tmp_path, capsys):
    from repro_torch.campaign import __main__ as cli

    assert cli.main(["--grid", "adaptive", "--quick", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    assert "BENCH_campaign_adaptive_quick" in capsys.readouterr().out
    port = json.loads((tmp_path / "BENCH_campaign_adaptive_quick.json")
                      .read_text())
    assert len(port["cells"]) == 3
    for c in port["cells"]:
        m = c["metrics"]
        assert m["converged"] and m["fp_budget_held"] and \
            m["detection_ok"], c["cell_id"]
    jax_now = json.loads(JAX_NOW.read_text())
    base = json.loads(BASELINE.read_text())
    for ref in (jax_now, base):
        gate = wilson_gate(ref, port)
        assert len(gate["cells"]) == 3 and not gate["uncovered"], gate
        assert all(c["detection"]["overlap"] for c in gate["cells"]), gate
    # the JAX CLI's artifact: 0 differ regressions (detection and FP,
    # 2 percentage points each); the port draws the same trials
    assert diff_artifacts(jax_now, port)["regressions"] == []
    for c, j in zip(port["cells"], jax_now["cells"]):
        assert abs(c["metrics"]["detected"] - j["metrics"]["detected"]) \
            <= 2, (c["cell_id"], c["metrics"]["detected"],
                   j["metrics"]["detected"])
    # the variance-shift gain over the best static bound, as JAX's
    vs = next(c["metrics"] for c in port["cells"]
              if "variance_shift" in c["cell_id"])
    assert vs["detection_rate"] > vs["best_static_detection"] + 0.2


# ------------------------------ the engine ----------------------------------

@pytest.mark.parametrize("op,cfg_kw", [
    ("qgemm", dict(fp_budget=0.5, hysteresis=1.0, min_checks=1,
                   cooldown_ticks=4, settle_ticks=2, floor=5e-6,
                   window_ticks=16)),
    ("embedding_bag", dict(fp_budget=0.5, hysteresis=1.0, min_checks=2,
                           cooldown_ticks=2, settle_ticks=3, floor=1e-7,
                           window_ticks=8))])
def test_engine_adaptive_loop_equals_jax(op, cfg_kw):
    """A ``threshold=adaptive`` plan: one controller per (op, tenant),
    ticked each iteration; every move rewrites the lane's plan (the port
    rebuilds its step closures; no kernel is rebuilt).  Every arrival at
    t = 0: the threshold events, the controllers' summaries and the
    lane's final bound equal the JAX engine's (op by op)."""
    from repro.configs import reduce_cfg
    from repro.configs.registry import get_arch
    from repro.protect import ProtectionPlan as JPlan
    from repro.serving import ServingEngine as JEngine, TenantSpec as JT
    from repro_torch.configs import get_arch as t_arch, reduce_cfg as t_red
    from repro_torch.models.convert import from_jax
    from repro_torch.protect import ProtectionPlan as TPlan
    from repro_torch.serving import (ServingEngine as TEngine,
                                     TenantSpec as TT, chat_stream)

    text = f"*:policy=log,{op}:threshold=adaptive"
    kw = dict(n_slots=2, max_prompt=8, max_new_tokens=4, seed=0)
    je = JEngine(reduce_cfg(get_arch("llama3.2-1b")),
                 [JT("t", JPlan.parse(text, name="t"))], **kw)
    te = TEngine(t_red(t_arch("llama3.2-1b")),
                 [TT("t", TPlan.parse(text, name="t"))], device="cpu",
                 **kw)
    te.params = from_jax(jax.tree.map(np.asarray, je.params), device="cpu")
    stream = [dataclasses.replace(r, arrival_s=0.0) for r in chat_stream(
        12, tenants={"t": 1.0}, rate_rps=500.0, seed=1, mean_prompt=6,
        max_prompt=8, mean_output=3, max_output=4)]
    outs = []
    for eng, pkg, apkg in ((te, tobs, tad), (je, jobs, jad)):
        ad = apkg.AdaptiveThresholds(config=apkg.ControllerConfig(**cfg_kw))
        with pytest.raises(ValueError, match="monitor"):
            eng.run(stream, adapt=ad)
        obs = pkg.Observability.create()
        mon = pkg.Monitor(rules=())
        if eng is je:
            with jax.disable_jit():
                tel = eng.run(stream, obs=obs, monitor=mon, adapt=ad)
        else:
            tel = eng.run(stream, obs=obs, monitor=mon, adapt=ad)
        s = tel.summary()
        assert s["per_tenant"]["t"]["completed"] == 12
        assert s["thresholds"] == ad.summary()
        ctrl = ad.controllers[(op, "t")]
        assert ctrl.adjustments >= 1
        assert eng._lane_of["t"].plan.resolve(op).rel_bound == \
            ctrl.rel_bound
        outs.append((_untimed(obs.bus), ad.summary()))
    assert outs[0] == outs[1]
    moves = [e for e in outs[0][0] if e["kind"] == "threshold"]
    assert moves and len(moves) == outs[0][1][0]["adjustments"]
    if op == "qgemm":
        assert all(e["attrs"]["direction"] == "lower" for e in moves)


def test_serve_cli_adaptive_logs_the_calibrated_bound(caplog):
    from repro_torch.launch import serve

    caplog.set_level("INFO")
    assert serve.main(["--arch", "llama3.2-1b", "--device", "cpu",
                       "--smoke", "--requests", "4", "--adaptive",
                       "--fp-budget", "0.01", "--calibrate-from",
                       str(THRESHOLDS), "--plan",
                       "*:policy=log,embedding_bag:threshold=adaptive"]) == 0
    bound = jad.calibrate_from_sweep(str(THRESHOLDS), fp_budget=0.01)
    text = caplog.text
    assert f"calibrated embedding_bag rel_bound={bound:.3g}" in text
    assert "threshold embedding_bag/default: rel_bound=" in text
