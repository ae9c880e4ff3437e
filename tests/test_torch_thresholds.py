"""The port's ``thresholds`` grid (the EB ``rel_bound`` sweep) against the
JAX package: the same cells, the same decisions on the same flips, rates
overlapping the committed JAX baseline, and the same tradeoff curve.

At ``rel_bound`` 1e-7 the bound is about one float32 ulp of a bag's
magnitude, so the summation order decides a clean bag's flag (ROADMAP
§C2): there, and for a faulty trial whose float64 margin lies within
``EB_ROUND_OFF`` of the bound (§C4), only counts are compared.  Elsewhere
the port's decision must equal the JAX package's, trial for trial.
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.campaign import artifacts as j_art  # noqa: E402
from repro.campaign import grids as j_grids  # noqa: E402
from repro.campaign import spec as j_spec  # noqa: E402
from repro.core.inject import flip_bit as j_flip_bit  # noqa: E402
from repro.protect.ops import EMBEDDING_BAG as J_EB  # noqa: E402
from repro.protect.plan import ResolvedRule as JRule  # noqa: E402
from repro_torch.campaign import __main__ as cli  # noqa: E402
from repro_torch.campaign import artifacts as t_art  # noqa: E402
from repro_torch.campaign import grids, spec  # noqa: E402
from repro_torch.campaign.diff import wilson_gate  # noqa: E402
from repro_torch.campaign.executor import _generators  # noqa: E402
from repro_torch.campaign.executor import run_campaign  # noqa: E402
from repro_torch.campaign.targets import (EB_ROUND_OFF, Fault,  # noqa: E402
                                          Trial, eb_margins, get_target)

BASELINES = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" \
    / "baselines"
BOUNDS = (1e-7, 1e-6, 1e-5, 1e-4, 1e-3)
#: the bound at which round-off decides clean bags (ROADMAP §C2)
ROUND_OFF_BOUND = 1e-7


def _baseline(name="thresholds"):
    return t_art.load_artifact(str(BASELINES / f"BENCH_campaign_{name}.json"))


def test_thresholds_grid_expands_as_jax():
    (t_sp,), (j_sp,) = grids.thresholds_specs(seed=0), \
        j_grids.thresholds_specs(seed=0)
    assert t_sp.to_dict() == j_sp.to_dict()
    t_plans, t_skip = spec.expand(t_sp)
    j_plans, j_skip = j_spec.expand(j_sp)
    assert [p.to_dict() for p in t_plans] == \
        [dataclasses.asdict(p) for p in j_plans]
    assert t_skip == j_skip and len(t_plans) == 15
    assert {p.cell_id for p in t_plans} == \
        {c["cell_id"] for c in _baseline()["cells"]}
    assert "thresholds" in grids.GRIDS and "thresholds" not in \
        grids.SHARDED_GRIDS


def _plan(band, rel_bound):
    cid = spec._cell_id("embedding_bag", "bitflip", band,
                        (10000, 128, 10, 100), "int8", rel_bound)
    return spec.CellPlan(cell_id=cid, target="embedding_bag",
                         fault_model="bitflip", bit_band=band,
                         shape=(10000, 128, 10, 100), dtype="int8",
                         samples=16, clean_samples=0, flips=1,
                         seed=spec.cell_seed(0, cid),
                         measure_overhead=False, rel_bound=rel_bound)


@pytest.mark.parametrize("band,bits", [("significant", (4, 8)),
                                       ("low", (0, 4)), ("sign", (7, 8))])
def test_decisions_equal_jax_at_every_bound(band, bits):
    target = get_target("embedding_bag")
    st = target.build(_plan(band, None), _generators(0)[0], device="cpu")
    enc = st["enc"]
    j_enc = [jnp.asarray(x.numpy()) for x in enc]
    rng = np.random.default_rng(17)
    trials = []
    for _ in range(12):
        idx = rng.integers(0, 10000, (10, 100)).astype(np.int32)
        row = int(idx[rng.integers(10), rng.integers(100)])
        col, bit = int(rng.integers(128)), int(rng.integers(*bits))
        trials.append((idx, row * 128 + col, bit))
    clean = [rng.integers(0, 10000, (10, 100)).astype(np.int32)
             for _ in range(6)]
    t0 = enc[0].clone()
    for rb in BOUNDS:
        plan = _plan(band, rb)
        compared = near = 0
        for idx, at, bit in trials:
            j_bad = j_flip_bit(j_enc[0], jnp.int32(at), jnp.int32(bit))
            _, jc = J_EB((j_bad,) + tuple(j_enc[1:]), jnp.asarray(idx),
                         rule=JRule(rel_bound=rb))
            t = Trial((Fault(at, bit),), torch.from_numpy(idx))
            det, cor = target.trial(st, plan, t)
            assert torch.equal(enc[0], t0)
            assert bool(cor) == bool(j_bad.reshape(-1)[at]
                                     != j_enc[0].reshape(-1)[at])
            (margin,) = eb_margins(st, plan, [t])
            if rb == ROUND_OFF_BOUND or abs(margin) <= EB_ROUND_OFF:
                near += 1
                continue
            compared += 1
            assert bool(det) == (int(jc.err_count) > 0)
            assert bool(det) == (margin > 0)
        flags = {"port": 0, "jax": 0}
        for idx in clean:
            _, jc = J_EB(tuple(j_enc), jnp.asarray(idx),
                         rule=JRule(rel_bound=rb))
            det, _ = target.trial(st, plan, Trial((), torch.from_numpy(idx)))
            flags["port"] += bool(det)
            flags["jax"] += int(jc.err_count) > 0
        if rb == ROUND_OFF_BOUND:
            # round-off decides: both flag clean bags, each by its order
            assert flags["port"] > 0 and flags["jax"] > 0
        else:
            assert flags == {"port": 0, "jax": 0}
            assert compared >= 8 and near <= 4


def test_thresholds_grid_on_the_cpu_overlaps_the_jax_baseline():
    base = _baseline()
    result = run_campaign("thresholds", grids.thresholds_specs(seed=0),
                          device="cpu")
    gate = wilson_gate(base, result)
    assert len(gate["cells"]) == 15 and gate["uncovered"] == []
    for c in gate["cells"]:
        assert c["detection"]["overlap"], c
        rb = float(c["cell_id"].rsplit("/rb", 1)[1])
        if rb != ROUND_OFF_BOUND:
            assert c["fp"]["overlap"], c
        else:            # both flag most clean bags, by their own orders
            assert c["fp"]["new"][0] > 0.2 and c["fp"]["old"][0] > 0.2
    curve = t_art.threshold_curve(result)
    assert sorted(curve) == ["low", "sign", "significant"]
    assert [rb for rb, _, _ in curve["low"]] == list(BOUNDS)


@pytest.mark.parametrize("name", ["thresholds", "pallas_quick",
                                  "training_quick"])
def test_artifact_readers_equal_jax_on_the_committed_baselines(name):
    path = BASELINES / f"BENCH_campaign_{name}.json"
    res = json.loads(path.read_text())
    j_res = j_art.load_artifact(str(path))
    for target in ("embedding_bag", "eb_pallas"):
        assert t_art.threshold_curve(res, target) == \
            j_art.threshold_curve(j_res, target)
        assert t_art.threshold_curve_markdown(res, target) == \
            j_art.threshold_curve_markdown(j_res, target)
    assert t_art.latency_markdown(res) == j_art.latency_markdown(j_res)
    cid = res["cells"][0]["cell_id"]
    assert json.dumps(t_art.cell_metrics(res, cid).to_dict()) == \
        json.dumps(dataclasses.asdict(j_art.cell_metrics(j_res, cid)))
    assert t_art.find_cells(res, fault_model="bitflip") == \
        j_art.find_cells(j_res, fault_model="bitflip")
    with pytest.raises(KeyError):
        t_art.cell_metrics(res, "no/such/cell")


def test_cli_runs_the_thresholds_grid_and_prints_the_curve(capsys,
                                                           tmp_path):
    assert cli.main(["--grid", "thresholds", "--device", "cpu",
                     "--samples", "4", "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "# EB rel_bound tradeoff curves (`embedding_bag`)" in out
    for band in ("low", "sign", "significant"):
        assert f"## band `{band}`" in out
    art = t_art.load_artifact(str(tmp_path / "BENCH_campaign_thresholds"
                                             ".json"))
    assert len(art["cells"]) == 15
