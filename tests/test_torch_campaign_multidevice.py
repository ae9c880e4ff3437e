"""The port's ``multidevice`` campaign grid (the training soaks over a
data mesh of ranks, ``repro_torch.campaign``) against the JAX package's,
on the CPU.

The CLI's ``--grid multidevice --quick`` (seed 0) runs once for the
module: it launches 4 ``gloo`` ranks (the JAX CLI forces 4 host
devices), every sharded cell's all-reduce a real collective over them.
The artifact is gated as the training grid is (ROADMAP §A8.2): every
cell's Wilson interval overlaps the committed JAX artifacts' (the
baseline at jax 0.4.37 and the unchanged JAX CLI's at this tree's jax,
``src/repro_torch/campaign/baselines/``), and the JAX differ passes.  The
faults are JAX's own draws; the weights are the port's, so detection
counts are held by interval, the bounds exactly.
"""
import dataclasses
import json
import warnings
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.campaign import diff as j_diff  # noqa: E402
from repro.campaign import grids as j_grids  # noqa: E402
from repro.campaign import spec as j_spec  # noqa: E402
from repro_torch.campaign import __main__ as cli  # noqa: E402
from repro_torch.campaign import grids, spec  # noqa: E402
from repro_torch.campaign.diff import wilson_gate  # noqa: E402
from repro_torch.campaign.executor import (resolve_device_count,  # noqa: E402
                                           run_specs)
from repro_torch.campaign.targets import get_target  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
BASELINES = {
    "jax-0.4.37": ROOT / "benchmarks/baselines/"
                         "BENCH_campaign_multidevice_quick.json",
    "jax-now": ROOT / "src/repro_torch/campaign/baselines/"
                      "BENCH_campaign_multidevice_quick.json",
}
ACCEPT = "train_payload_shard/bitflip/significant/2x16/int8/steps2/shards4"
REDUCED = "train_reduced/bitflip/significant/2x16/int32/steps2/shards4"


@pytest.fixture(scope="module")
def artifact(tmp_path_factory):
    """The CLI's ``--grid multidevice --quick`` on 4 CPU ranks."""
    out = tmp_path_factory.mktemp("md")
    assert cli.main(["--grid", "multidevice", "--quick", "--device", "cpu",
                     "--out", str(out)]) == 0
    path = out / "BENCH_campaign_multidevice_quick.json"
    return path, json.loads(path.read_text())


def _cells(art):
    return {c["cell_id"]: c["metrics"] for c in art["cells"]}


def test_grid_expands_as_jax():
    """The same specs, cells, seeds and skips as JAX's grid (quick and
    full, and the ``full`` grid that holds it)."""
    for quick in (True, False):
        t_specs = grids.multidevice_specs(seed=0, quick=quick)
        j_specs = j_grids.multidevice_specs(seed=0, quick=quick)
        assert [s.to_dict() for s in t_specs] == \
            [s.to_dict() for s in j_specs]
        for t_sp, j_sp in zip(t_specs, j_specs):
            t_plans, t_skip = spec.expand(t_sp)
            j_plans, j_skip = j_spec.expand(j_sp)
            assert [p.to_dict() for p in t_plans] == \
                [dataclasses.asdict(p) for p in j_plans]
            assert t_skip == j_skip
    assert [s.to_dict() for s in grids.full_specs(0)] == \
        [s.to_dict() for s in j_grids.full_specs(0)]
    assert grids.SHARDED_GRIDS == ("multidevice", "full")


def test_acceptance_cell_attributes_to_shard_0(artifact):
    """One rank's payload flipped in transit: seen after the collective
    at the step it struck, attributed to rank 0 alone, over a real
    4-rank all-reduce (JAX's ``tests/test_campaign_multidevice.py``)."""
    m = _cells(artifact[1])[ACCEPT]
    n = m["samples"]
    assert m["collective_verified"] is True and m["shards"] == 4
    assert m["raw_detection_rate"] == 1.0 and m["detection_rate"] == 1.0
    assert m["escapes"] == 0 and m["false_positives"] == 0
    assert m["detection_latency_hist"] == [n, 0]
    assert m["shard_detections"] == [n, 0, 0, 0]
    assert m["analytic_bound"] == 1.0


def test_reduced_and_contrast_cells(artifact):
    """The summed payload after the verify escapes every time (bound 0);
    ``train_payload`` flips every rank's payload alike: each rank's own
    verify fires; one rank alone has no collective to verify."""
    cells = _cells(artifact[1])
    red = cells[REDUCED]
    assert red["detected"] == 0 and red["escapes"] == red["samples"]
    assert red["analytic_bound"] == 0.0 and red["collective_verified"]
    one = cells["train_payload/bitflip/significant/2x16/int8/steps2"]
    assert one["shards"] == 1 and one["collective_verified"] is False
    assert one["shard_detections"] is None
    four = cells["train_payload/bitflip/significant/2x16/int8/steps2/"
                 "shards4"]
    assert four["shard_detections"] == [four["samples"]] * 4
    assert four["escapes"] == 0
    assert artifact[1]["env"]["ranks"] == 4


def test_artifact_keeps_grid_order_though_sharded_cells_run_first(
        artifact):
    """The world runs the sharded cells first and rank 0 the one-rank
    cell after them, alone (no rank waits in a collective for it); the
    artifact lists the cells in the grid's order, as JAX's does."""
    want = [p.cell_id for sp in grids.multidevice_specs(0, quick=True)
            for p in spec.expand(sp)[0]]
    got = [c["cell_id"] for c in artifact[1]["cells"]]
    assert got == want
    assert [c["metrics"]["shards"] for c in artifact[1]["cells"]] == \
        [4, 4, 1, 4]


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_grid_within_the_jax_intervals(artifact, name):
    """Every cell's 95% Wilson interval (detection, escape, FP) overlaps
    the JAX artifact's; no cell is left out."""
    ref = json.loads(BASELINES[name].read_text())
    gate = wilson_gate(ref, artifact[1])
    assert not gate["failed"] and not gate["uncovered"]
    assert len(gate["cells"]) == 4


@pytest.mark.parametrize("name", sorted(BASELINES))
def test_jax_differ_passes(artifact, name, capsys):
    """``python -m repro.campaign --diff <JAX artifact> <port artifact>``
    finds no regression."""
    assert j_diff.run_diff(str(BASELINES[name]), str(artifact[0])) == 0
    assert "0 regression(s)" in capsys.readouterr().out


def test_a_small_world_degrades_with_a_warning():
    """Without a world (one rank) a 4-shard cell runs at one shard, says
    so, and does not count as collective-verified (JAX's degradation on
    a one-device host)."""
    sp = dataclasses.replace(grids.multidevice_specs(0, quick=True)[0],
                             targets=("train_payload_shard",),
                             dtypes=("int8",), samples=1, clean_samples=0)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        (r,), _ = run_specs([sp], device="cpu")
    assert any("running at 1 shard" in str(x.message) for x in w)
    assert r.metrics.shards == 1 and r.metrics.collective_verified is False
    assert r.metrics.detected == 1


def test_mesh_seams_are_registered_shardable():
    for name, bound in (("train_payload_shard", 1.0),
                        ("train_reduced", 0.0)):
        t = get_target(name)
        assert t.shardable and t.soak is not None
        plan = spec.expand(dataclasses.replace(
            grids.multidevice_specs(0, quick=True)[0],
            targets=(name,)))[0][0]
        assert t.analytic_bound(plan) == bound


@pytest.mark.parametrize("requested,device,want", [
    (None, "cpu", 1), (4, "cpu", 4), (7, "cpu", 7)])
def test_resolve_device_count(requested, device, want):
    """On the CPU ranks are processes: any count is there."""
    assert resolve_device_count(requested, device) == want
