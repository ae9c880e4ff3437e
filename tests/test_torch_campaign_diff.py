"""The port's artifacts and differ against the JAX package's.

The port writes the JAX package's ``BENCH_campaign_*.json`` schema, so the
JAX loader and differ read a port artifact unchanged; the port's own copy
of the differ must give the JAX differ's record on the same artifacts.
"""
import json
import pathlib

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

from repro.campaign.artifacts import cell_metrics as j_cell_metrics  # noqa
from repro.campaign.artifacts import load_artifact as j_load  # noqa: E402
from repro.campaign.diff import diff_artifacts as j_diff  # noqa: E402
from repro.campaign.diff import format_diff as j_format  # noqa: E402
from repro.campaign.metrics import wilson_interval as j_wilson  # noqa
from repro_torch.campaign import __main__ as cli  # noqa: E402
from repro_torch.campaign import grids  # noqa: E402
from repro_torch.campaign.artifacts import (load_artifact,  # noqa: E402
                                            write_artifacts)
from repro_torch.campaign.diff import (diff_artifacts,  # noqa: E402
                                       format_diff, wilson_gate)
from repro_torch.campaign.executor import run_campaign  # noqa: E402
from repro_torch.campaign.metrics import wilson_interval  # noqa: E402

BASELINES = pathlib.Path(__file__).resolve().parents[1] / "benchmarks" \
    / "baselines"


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    out = tmp_path_factory.mktemp("camp")
    # the pallas grid at 40 samples: cheap, and far enough from the
    # baseline's 400 that the differ has rates to report
    result = run_campaign("pallas_quick",
                          grids.pallas_specs(seed=0, quick=True, samples=40),
                          device="cpu")
    path, md = write_artifacts(result, str(out))
    assert pathlib.Path(md).read_text().startswith("# Resilience campaign")
    return {"port": path,
            "pallas": str(BASELINES / "BENCH_campaign_pallas_quick.json"),
            "quick": str(BASELINES / "BENCH_campaign_quick.json")}


def test_the_jax_loader_reads_a_port_artifact(artifacts):
    jres = j_load(artifacts["port"])
    assert load_artifact(artifacts["port"]) == jres
    for c in jres["cells"]:
        m = j_cell_metrics(jres, c["cell_id"])
        assert m.samples == 40 and m.clean_samples == 64


@pytest.mark.parametrize("old,new", [
    ("pallas", "port"), ("port", "pallas"), ("quick", "port"),
    ("pallas", "quick"), ("quick", "quick")])
@pytest.mark.parametrize("tols", [
    {}, {"det_tol": 0.0, "fp_tol": 0.0, "overhead_tol": 0.1}])
def test_port_differ_equals_jax_differ(artifacts, old, new, tols):
    a, b = (json.loads(pathlib.Path(artifacts[k]).read_text())
            for k in (old, new))
    got = diff_artifacts(a, b, **tols)
    assert got == j_diff(a, b, **tols)
    assert format_diff(got) == j_format(got)


def test_cli_diff_exit_codes(artifacts, capsys):
    assert cli.main(["--diff", artifacts["pallas"], artifacts["pallas"]]) == 0
    assert cli.main(["--diff", artifacts["quick"], artifacts["port"]]) == 1
    assert "coverage" in capsys.readouterr().out


def test_wilson_gate(artifacts):
    assert [wilson_interval(k, n) for k, n in ((0, 0), (3, 40), (40, 40))] \
        == [j_wilson(k, n) for k, n in ((0, 0), (3, 40), (40, 40))]
    base = load_artifact(artifacts["pallas"])
    same = wilson_gate(base, base)
    assert same["failed"] == [] and len(same["cells"]) == 7
    # a cell whose detection collapses no longer overlaps
    worse = json.loads(json.dumps(base))
    m = worse["cells"][0]["metrics"]
    m["effective_detected"], m["false_positives"] = 200, 0
    gate = wilson_gate(base, worse)
    assert gate["failed"] == [worse["cells"][0]["cell_id"]]
    assert not gate["cells"][[c["cell_id"] for c in gate["cells"]].index(
        gate["failed"][0])]["detection"]["overlap"]
    # and a baseline cell the new artifact lacks is reported uncovered
    fewer = dict(base, cells=base["cells"][1:])
    assert wilson_gate(base, fewer)["uncovered"] == \
        [base["cells"][0]["cell_id"]]
