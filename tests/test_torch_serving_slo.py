"""The port's serving SLO ladder (``repro_torch.benchmarks.serving_slo``)
against the JAX package's ``benchmarks/serving_slo.py``, on the CPU.

Times here are the CPU's host times, exercised only for their columns;
what is held is the ladder (the same three plans, flags and artifact
keys), that every rung serves the whole stream, and that the
unprotected rung checks nothing: all its counters are 0.
"""
import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from benchmarks import serving_slo as j_slo  # noqa: E402
from repro_torch.benchmarks import serving_slo as t_slo  # noqa: E402

_KW = dict(requests=4, rate=300.0, arrival="poisson", slots=2, max_new=4,
           seed=0, smoke=True)


def _flags(mod, capsys):
    import re
    with pytest.raises(SystemExit):
        mod.main(["--help"])
    return set(re.findall(r"--[a-z][a-z-]*", capsys.readouterr().out))


def test_the_ladder_is_the_jax_one(capsys):
    assert t_slo.PLANS == j_slo.PLANS
    assert _flags(t_slo, capsys) == _flags(j_slo, capsys) | {"--device"}


@pytest.mark.parametrize("arch", ["llama3.2-1b", "granite-moe-3b-a800m"])
def test_ladder_on_the_cpu(arch):
    lines = []
    res = t_slo.run_ladder(arch, device="cpu", emit=lines.append, **_KW)
    assert list(res["plans"]) == [n for n, _ in t_slo.PLANS]
    assert res["env"]["backend"] == "cpu"
    for name, row in res["plans"].items():
        assert row["completed"] == _KW["requests"]
        for k in ("ttft_ms", "per_token_ms", "e2e_ms"):
            assert set(row[k]) >= {"p50", "p95", "p99"}
        c = row["counters"]
        if name == "unprotected":
            assert all(v == 0 for v in c.values()), c
        else:
            assert c["qgemm_checks"] > 0 and c["embedding_bag_checks"] > 0
            assert c["qgemm_errors"] == c["embedding_bag_errors"] == 0
            assert row["ttft_p99_ratio"] > 0 and row["tok_p99_ratio"] > 0
    assert res["plans"]["recompute+kv"]["counters"]["kv_cache_checks"] > 0
    assert res["plans"]["log"]["counters"]["kv_cache_checks"] == 0
    assert len(lines) == 3 + 2


def test_cli_writes_the_jax_artifact_keys(tmp_path):
    assert t_slo.main(["--quick", "--device", "cpu", "--requests", "4",
                       "--decode-tokens", "4", "--out", str(tmp_path)]) == 0
    got = json.loads((tmp_path / "BENCH_serving_slo.json").read_text())
    j_out = tmp_path / "jax"
    assert j_slo.main(["--quick", "--decode-tokens", "4",
                       "--out", str(j_out)]) == 0
    want = json.loads((j_out / "BENCH_serving_slo.json").read_text())
    assert set(got) == set(want) | {"env"}
    assert got["requests"] == want["requests"] == 40
    for name in want["plans"]:
        assert set(got["plans"][name]) >= set(want["plans"][name])
        assert got["plans"][name]["plan"] == want["plans"][name]["plan"]


def test_ladder_cuts_the_depth_on_request():
    """A config cut in depth, width kept, is served as given: each
    protected rung checks one layer's projections and the head a step."""
    import dataclasses

    from repro_torch.configs import get_arch, reduce_cfg
    full = t_slo.run_ladder("llama3.2-1b", device="cpu", emit=lambda m: 0,
                            **_KW)
    # the reduced config (what ``smoke`` serves) at 1 of its 2 layers
    cut = dataclasses.replace(reduce_cfg(get_arch("llama3.2-1b")),
                              n_layers=1)
    one = t_slo.run_ladder(cut, device="cpu", emit=lambda m: 0,
                           **dict(_KW, smoke=False))
    assert one["arch"] == full["arch"] == "llama3.2-1b"
    for name in ("log", "recompute+kv"):
        got, want = one["plans"][name], full["plans"][name]
        assert got["completed"] == want["completed"] == _KW["requests"]
        # the reduced Llama's 2 layers of 7 projections and the head a
        # step, against 1 layer's and the head
        assert want["counters"]["qgemm_checks"] == 15 * want["steps"]
        assert got["counters"]["qgemm_checks"] == 8 * got["steps"]
