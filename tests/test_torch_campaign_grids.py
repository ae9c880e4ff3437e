"""The port's main-path grids on the CPU (the plain versions of K1 and K2)
against the committed JAX baselines, at the baselines' own sample counts
and seed: every main-path cell's detection and false-positive rates must
overlap the baseline's by 95% Wilson interval.  The two packages draw
their faults from different generators, so rates agree statistically,
not trial for trial."""
import pathlib

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

from repro_torch.campaign import grids  # noqa: E402
from repro_torch.campaign.artifacts import load_artifact  # noqa: E402
from repro_torch.campaign.diff import wilson_gate  # noqa: E402
from repro_torch.campaign.executor import run_campaign  # noqa: E402

BASELINES = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" \
    / "baselines"


def _gate(name, specs, n_cells, uncovered=()):
    base = load_artifact(str(BASELINES / f"BENCH_campaign_{name}.json"))
    result = run_campaign(name, specs, device="cpu")
    gate = wilson_gate(base, result)
    assert len(gate["cells"]) == n_cells
    assert gate["failed"] == [], [c for c in gate["cells"]
                                  if c["cell_id"] in gate["failed"]]
    assert gate["uncovered"] == sorted(uncovered)
    assert result["env"]["backend"] == "cpu"
    return result


def test_pallas_grid_overlaps_the_jax_baseline():
    result = _gate("pallas_quick", grids.pallas_specs(seed=0, quick=True), 7)
    assert {c["metrics"]["samples"] for c in result["cells"]} == {400}
    assert {c["metrics"]["clean_samples"] for c in result["cells"]} == {100}
    for c in result["cells"]:
        m = c["metrics"]
        assert m["overhead"] is not None and m["overhead_breakdown"]


def test_quick_grid_overlaps_the_jax_baseline():
    kv_and_decode = ["decode_step/bitflip/significant/2x16/int8",
                     "kv_cache/bitflip/all/2x2x128x64/float32",
                     "kv_cache/bitflip/all/2x2x128x64/int8"]
    result = _gate("quick", grids.quick_specs(seed=0), 13)
    ran = {c["cell_id"]: c["metrics"] for c in result["cells"]}
    skipped = {s["cell_id"] for s in result["skipped"]}
    for cid in kv_and_decode:
        assert cid in ran and cid not in skipped
    assert ran[kv_and_decode[2]]["detection_rate"] == 1.0
    assert ran[kv_and_decode[1]]["raw_detection_rate"] == 0.0
    assert ran[kv_and_decode[0]]["steps"] == 1
