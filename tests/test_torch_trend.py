"""The port's longitudinal trend gate (``repro_torch.campaign.trend``,
``python -m repro_torch.campaign --trend``) against the JAX package's
``repro.campaign.trend``, on the CPU: the same artifact series gives the
same markdown history and the same exit code, on the committed baselines,
with a port artifact as the newest entry, and on regression and
coverage-loss cases."""
import copy
import json
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro.campaign import trend as jtrend  # noqa: E402
from repro_torch.campaign import __main__ as cli  # noqa: E402
from repro_torch.campaign import trend as ttrend  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
QUICK = ROOT / "benchmarks" / "baselines" / "BENCH_campaign_quick.json"


def both(paths, **kw):
    """(rc, markdown) of each package's ``run_trend`` on ``paths``."""
    out = []
    for mod in (ttrend, jtrend):
        lines = []
        rc = mod.run_trend([str(p) for p in paths], emit=lines.append, **kw)
        out.append((rc, "\n".join(lines)))
    assert out[0] == out[1]
    return out[0]


def _write(tmp_path, name, art):
    p = tmp_path / name
    p.write_text(json.dumps(art))
    return p


def test_default_paths_and_committed_history_equal_jax():
    assert ttrend.default_baseline_paths(str(ROOT)) == \
        jtrend.default_baseline_paths(str(ROOT))
    paths = ttrend.default_baseline_paths(str(ROOT))
    assert any(p.endswith("BENCH_campaign_quick.json") for p in paths)
    rc, md = both(paths)
    assert rc == 0 and "Detection-quality trend" in md


@pytest.fixture(scope="module")
def port_quick(tmp_path_factory):
    """The port's quick grid on the CPU (seed 0), as an artifact."""
    out = tmp_path_factory.mktemp("quick")
    assert cli.main(["--quick", "--device", "cpu", "--out", str(out)]) == 0
    return out / "BENCH_campaign_quick.json"


def test_port_artifact_as_the_newest_entry_passes(port_quick):
    """The committed quick history with the port's CPU artifact as its
    newest entry: no trend regression, both packages agree."""
    history = sorted((ROOT / "benchmarks" / "baselines").glob(
        "BENCH_campaign_quick*.json"))
    rc, md = both(history + [port_quick])
    assert rc == 0, md
    assert "No trend regressions" in md


def test_coverage_loss_gates_in_both(port_quick, tmp_path):
    art = json.loads(port_quick.read_text())
    gone = art["cells"].pop(0)["cell_id"]
    newest = _write(tmp_path, "BENCH_campaign_quick_new.json", art)
    rc, md = both([QUICK, port_quick, newest])
    assert rc == 1 and gone in md and "coverage" in md


SCENARIOS = {
    "det_drop": lambda a: a["cells"][0]["metrics"].update(
        detection_rate=a["cells"][0]["metrics"]["detection_rate"] - 0.1),
    "fp_rise": lambda a: a["cells"][1]["metrics"].update(
        fp_rate=a["cells"][1]["metrics"]["fp_rate"] + 0.05),
    "small_moves": lambda a: [c["metrics"].update(
        detection_rate=c["metrics"]["detection_rate"] - 0.01)
        for c in a["cells"]],
    "overhead_rise": lambda a: a["cells"][2]["metrics"].update(
        overhead=(a["cells"][2]["metrics"].get("overhead") or 0.0) + 1.0),
    "improvement": lambda a: a["cells"][3]["metrics"].update(
        detection_rate=min(1.0, a["cells"][3]["metrics"]["detection_rate"]
                           + 0.2)),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
@pytest.mark.parametrize("latency_tol", [None, 0.05])
def test_series_scenarios_equal_jax(tmp_path, name, latency_tol):
    base = json.loads(QUICK.read_text())
    paths = [_write(tmp_path, f"BENCH_campaign_quick_v{i}.json", base)
             for i in range(2)]
    # one noisy middle entry the median must absorb
    noisy = copy.deepcopy(base)
    noisy["cells"][0]["metrics"]["detection_rate"] -= 0.5
    paths.append(_write(tmp_path, "BENCH_campaign_quick_v2.json", noisy))
    new = copy.deepcopy(base)
    SCENARIOS[name](new)
    paths.append(_write(tmp_path, "BENCH_campaign_quick_v3.json", new))
    out = tmp_path / "hist.md"
    rc, md = both(paths, latency_tol=latency_tol, out_path=str(out))
    assert out.read_text() == md
    want = {"det_drop": 1, "fp_rise": 1, "small_moves": 0,
            "overhead_rise": int(latency_tol is not None),
            "improvement": 0}[name]
    assert rc == want, md


def test_single_entry_cells_listed_not_gated():
    for mod in (ttrend, jtrend):
        history = mod.load_history([str(QUICK)])
        report = mod.trend_gate(history)
        assert report["gated_cells"] == 0 and report["ungated_cells"] > 0
    assert ttrend.format_trend(history, report) == \
        jtrend.format_trend(history, report)


def test_cli_trend_and_trend_out(tmp_path, capsys):
    base = json.loads(QUICK.read_text())
    paths = [str(_write(tmp_path, f"v{i}.json", base)) for i in range(3)]
    assert cli.main(["--trend", *paths]) == 0
    assert "Detection-quality trend" in capsys.readouterr().out
    bad = copy.deepcopy(base)
    bad["cells"][0]["metrics"]["detection_rate"] -= 0.10
    paths[-1] = str(_write(tmp_path, "bad.json", bad))
    out = tmp_path / "cli_hist.md"
    assert cli.main(["--trend", *paths, "--trend-out", str(out)]) == 1
    assert "Trend regressions" in out.read_text()
    assert cli.main(["--trend", *paths, "--det-tol", "0.2"]) == 0
