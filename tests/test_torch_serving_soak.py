"""The port's ``serving_soak`` grid (``repro_torch.serving.soak``) and the
campaign CLI's ``--grid serving_soak`` / ``--plan`` against the JAX
package, on the CPU.

The engines' clock is hybrid (service time is step wall time), so where
arrivals spread over time admission follows each machine's speed.  The
gate is in two parts:

* at 1e6 requests/s every arrival lands in the first step, so both
  engines batch the same requests into the same steps: the port's cell
  is held EQUAL to a JAX soak over the same stream and weights — each
  injection's step, victim leaf, detection and latency in steps, the
  corrupted and escaped counts, the clean pass's flagged steps and every
  counter.  A flip's element is drawn from a ``torch.Generator`` in the
  port and from ``jax.random`` in JAX; the test hands the port JAX's
  element, so that whether the flip moves a token is the same question
  on both sides;
* at the quick spec's 200 requests/s the rates are held by Wilson
  overlap (``campaign.diff.wilson_gate``: detection, escape and FP)
  against the committed JAX baseline
  (``src/repro_torch/campaign/baselines/``), and the port's differ
  returns 0.

The burst-rate JAX soak runs op by op (``jax.disable_jit``): jitted, its
quantizers multiply by the reciprocal of 255 (ROADMAP §C5), which on
these streams moves tokens where the bf16 top two logits tie, and with
them which requests a fault corrupts.  Op by op its tokens are the
port's, in the clean and the faulty pass.
"""
import dataclasses
import json
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.serving import soak as jsoak  # noqa: E402
from repro_torch.campaign import __main__ as cli  # noqa: E402
from repro_torch.campaign.diff import run_diff, wilson_gate  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.serving import soak as tsoak  # noqa: E402

BASELINE = (Path(tsoak.__file__).resolve().parents[1] / "campaign"
            / "baselines" / "BENCH_campaign_serving_soak_quick.json")


def _baseline():
    return json.loads(BASELINE.read_text())


def test_specs_and_plans_are_the_jax_ones():
    assert tsoak.DEFAULT_TENANTS == jsoak.DEFAULT_TENANTS
    assert tsoak.SOAK_ARCH == jsoak.SOAK_ARCH
    for t_spec, j_spec in ((tsoak.quick_soak_spec(0), jsoak.quick_soak_spec(0)),
                           (tsoak.full_soak_spec(3), jsoak.full_soak_spec(3))):
        assert t_spec.to_dict() == j_spec.to_dict()
        assert [p.to_dict() for p in tsoak.soak_plans(t_spec)] == \
            [p.to_dict() for p in jsoak.soak_plans(j_spec)]
    base = _baseline()
    assert base["specs"] == [json.loads(json.dumps(
        tsoak.quick_soak_spec(0).to_dict()))]
    assert [c["plan"]["inject_steps"] for c in base["cells"]] == \
        [list(p.inject_steps) for p in
         tsoak.soak_plans(tsoak.quick_soak_spec(0))]


def _jax_flip(je, inj_seed, victim):
    """JAX's flipped (flat index, bit) for an injection seed."""
    from repro.core.inject import random_bitflip_live, victim_leaf_index
    leaves = jax.tree_util.tree_leaves(je.params)
    idx, path = victim_leaf_index(je.params, victim)
    clean = np.asarray(leaves[idx])
    bad = np.asarray(random_bitflip_live(jax.random.key(inj_seed),
                                         leaves[idx], path))
    (flat,) = np.flatnonzero(clean.reshape(-1) != bad.reshape(-1))
    x = int(clean.reshape(-1)[flat].view(np.uint8)) ^ \
        int(bad.reshape(-1)[flat].view(np.uint8))
    return int(flat), x.bit_length() - 1


@pytest.mark.parametrize("arrival,victim,persistent", [
    ("poisson", None, False), ("bursty", "attn.wq", True)])
def test_burst_rate_cell_equals_the_jax_cell(monkeypatch, arrival, victim,
                                             persistent):
    plan_kw = dict(cell_id=f"serving_soak/{arrival}", target="serving_soak",
                   arrival=arrival, arch=tsoak.SOAK_ARCH, n_requests=4,
                   n_slots=4, rate_rps=1e6, inject_steps=(3,),
                   victim=victim, persistent=persistent, seed=0)
    j_plan = jsoak.SoakCellPlan(**plan_kw)
    t_plan = tsoak.SoakCellPlan(**plan_kw)
    from repro.configs import reduce_cfg
    from repro.configs.registry import get_arch
    from repro.serving.engine import ServingEngine as JEngine
    je = JEngine(reduce_cfg(get_arch(j_plan.arch)),
                 jsoak._tenant_specs(j_plan.tenants), n_slots=4,
                 max_prompt=32, max_new_tokens=16, seed=0)
    te = tsoak.build_engine(t_plan.arch, t_plan.tenants, 4, 16, 0, "cpu")
    te.params = from_jax(jax.tree.map(np.asarray, je.params), device="cpu")
    # the port flips JAX's element (the module docstring)
    coords = _jax_flip(je, t_plan.seed, victim)
    import repro_torch.core.inject as tinj
    monkeypatch.setattr(tinj, "draw_bitflip_live",
                        lambda gen, leaf, path="", bit_range=None: coords)
    with jax.disable_jit():
        j_cell = jsoak.run_soak_cell(j_plan, engine=je, keep_telemetry=True)
    t_cell = tsoak.run_soak_cell(t_plan, engine=te, keep_telemetry=True)
    jm, tm = j_cell["metrics"].to_dict(), t_cell["metrics"].to_dict()
    keys = ("step", "victim", "detected", "detect_step", "latency_steps",
            "persistent", "attributed_rids")
    assert [{k: i[k] for k in keys} for i in tm["injections"]] == \
        [{k: (list(i[k]) if k == "attributed_rids" else i[k]) for k in keys}
         for i in jm["injections"]]
    for k in ("samples", "detected", "corrupted", "escapes", "clean_samples",
              "false_positives", "detection_latency_steps"):
        assert tm[k] == jm[k], k
    assert tm["detected"] == 1 and tm["escapes"] == 0
    for kind in ("clean", "faulty"):
        jt, tt = j_cell["telemetry"][kind], t_cell["telemetry"][kind]
        assert tt.detection_steps() == jt.detection_steps()
        assert [(e.step, e.kind, e.lane, e.slot_rids) for e in tt.steps] \
            == [(e.step, e.kind, e.lane, e.slot_rids) for e in jt.steps]
        tc = tt.summary()["faults"]["counters"]
        jc = jt.summary()["faults"]["counters"]
        assert tc == {k: jc[k] for k in tc}
        assert tsoak._token_map(tt) == jsoak._token_map(jt)
    assert tm["injections"][0]["victim"].startswith(
        "layers.attn.wq" if victim else "layers.mlp.down")


def test_quick_grid_overlaps_the_jax_baseline(tmp_path, capsys):
    """``--grid serving_soak --quick --device cpu`` at 200 requests/s:
    detection 1/1 in both cells, 0 escapes, and Wilson overlap with the
    committed JAX artifact, whose differ verdict is 0 regressions."""
    assert cli.main(["--grid", "serving_soak", "--quick", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    out = tmp_path / "BENCH_campaign_serving_soak.json"
    res = json.loads(out.read_text())
    assert res["env"]["backend"] == "cpu"
    assert [c["cell_id"] for c in res["cells"]] == \
        [c["cell_id"] for c in _baseline()["cells"]]
    for c in res["cells"]:
        m = c["metrics"]
        assert (m["samples"], m["detected"], m["escapes"]) == (1, 1, 0)
        assert set(m["slo"]) == {"premium", "standard"}
    gate = wilson_gate(_baseline(), res)
    assert not gate["failed"] and not gate["uncovered"]
    assert all("escape" in c for c in gate["cells"])
    assert run_diff(str(BASELINE), str(out)) == 0
    assert "0 regression(s)" in capsys.readouterr().out


def test_plan_override_reaches_every_tenant(tmp_path, monkeypatch):
    """``--plan @file`` replaces every tenant's plan text unparsed, as the
    JAX CLI does (one poisson cell of 16 requests, to stay small)."""
    plan_file = tmp_path / "plan.json"
    plan_file.write_text(json.dumps("*:policy=log,kv_cache:on"))
    seen = []
    real = tsoak.run_soak_campaign

    def small(spec, **kw):
        seen.append(spec)
        return real(dataclasses.replace(spec, n_requests=16,
                                        arrivals=("poisson",)), **kw)
    monkeypatch.setattr(tsoak, "run_soak_campaign", small)
    assert cli.main(["--grid", "serving_soak", "--quick", "--device",
                     "cpu", "--plan", f"@{plan_file}", "--out",
                     str(tmp_path)]) == 0
    (got,) = seen
    assert got.tenants == tuple((n, w, f"@{plan_file}")
                                for n, w, _ in tsoak.DEFAULT_TENANTS)
    res = json.loads((tmp_path / "BENCH_campaign_serving_soak.json")
                     .read_text())
    (cell,) = res["cells"]
    assert cell["metrics"]["samples"] == 1
    assert [t[2] for t in cell["plan"]["tenants"]] == [f"@{plan_file}"] * 2
    # both tenants share the parsed plan: one lane, its KV cache checked
    engine = tsoak.build_engine(got.arch, got.tenants, 4, 16, 0, "cpu")
    (lane,) = engine.lanes
    assert lane.plan.resolve("kv_cache", "attn").enabled


def test_paging_grid_takes_the_plan(tmp_path):
    assert cli.main(["--grid", "paging", "--quick", "--plan",
                     "*:policy=recompute,kv_cache_paged:on", "--device",
                     "cpu", "--out", str(tmp_path)]) == 0
    res = json.loads((tmp_path / "BENCH_campaign_paging_quick.json")
                     .read_text())
    assert res["specs"][0]["plan"] == "*:policy=recompute,kv_cache_paged:on"
    parity = next(c for c in res["cells"] if "parity" in c["cell_id"])
    assert parity["plan"]["plan"] == "*:policy=recompute,kv_cache_paged:on"


def test_plan_is_refused_for_the_trial_grids(capsys):
    with pytest.raises(SystemExit) as ei:
        cli.main(["--grid", "pallas", "--quick", "--device", "cpu",
                  "--plan", "*:off"])
    assert ei.value.code == 2
    assert "--plan applies to" in capsys.readouterr().err
