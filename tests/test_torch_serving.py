"""The port's serving engine on the CPU against the JAX engine, on the same
seeded DLRM request stream at the ``serve --smoke`` size."""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

from repro.configs.dlrm import CONFIG as J_CFG  # noqa: E402
from repro.configs.dlrm import EXTRAS as J_EXTRAS  # noqa: E402
from repro.protect import default_plan as j_default_plan  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import TenantSpec as JTenant  # noqa: E402
from repro.serving import dlrm_stream as j_stream  # noqa: E402
from repro_torch.configs.dlrm import CONFIG as T_CFG  # noqa: E402
from repro_torch.configs.dlrm import EXTRAS as T_EXTRAS  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.protect import ProtectionPlan, default_plan  # noqa: E402
from repro_torch.serving import ServingEngine, TenantSpec  # noqa: E402
from repro_torch.serving import dlrm_stream  # noqa: E402

_SMOKE = dict(table_rows=512, n_tables=4, emb_dim=32, bottom_mlp=(64, 32),
              top_mlp=(64, 32, 1))


def _stream(fn, ex, n=4, tenants=None):
    return fn(n, tenants=tenants or {"default": 1.0}, seed=0,
              lookup_batch=10, table_rows=ex.table_rows,
              n_tables=ex.n_tables)


def test_stream_is_the_jax_stream():
    ex = dataclasses.replace(T_EXTRAS, **_SMOKE)
    for t, j in zip(_stream(dlrm_stream, ex, 6),
                    _stream(j_stream, dataclasses.replace(J_EXTRAS,
                                                          **_SMOKE), 6)):
        assert (t.rid, t.tenant, t.arrival_s, t.seed) == \
            (j.rid, j.tenant, j.arrival_s, j.seed)
        assert (t.payload["bags"] == j.payload["bags"]).all()
        assert (t.payload["dense"] == j.payload["dense"]).all()


def test_engine_serves_stream_with_jax_fault_counters():
    t_ex = dataclasses.replace(T_EXTRAS, **_SMOKE)
    j_ex = dataclasses.replace(J_EXTRAS, **_SMOKE)
    eng = ServingEngine(T_CFG, [TenantSpec("default", default_plan())],
                        dlrm_extras=t_ex, device="cpu")
    tel = eng.run(_stream(dlrm_stream, t_ex))
    s = tel.summary()
    assert s["per_tenant"]["default"]["completed"] == 4
    assert s["per_tenant"]["default"]["aborted"] == 0
    assert all(ev.duration_s > 0 for ev in tel.steps)

    j_eng = JEngine(J_CFG, [JTenant("default", j_default_plan())],
                    dlrm_extras=j_ex)
    j_counters = j_eng.run(_stream(j_stream, j_ex)).summary()[
        "faults"]["counters"]
    counters = s["faults"]["counters"]
    # other test modules may register extra JAX op kinds in this process
    assert all(j_counters[k] == 0 for k in set(j_counters) - set(counters))
    assert counters == {k: j_counters[k] for k in counters}
    assert counters["qgemm_checks"] == 4 * 5
    assert counters["embedding_bag_checks"] == 4 * 4


def test_engine_lanes_per_plan_and_abort():
    ex = dataclasses.replace(T_EXTRAS, **_SMOKE)
    plans = {"a": ProtectionPlan.parse("*:policy=abort"),
             "b": ProtectionPlan.parse("*:policy=log,embedding_bag:off")}
    eng = ServingEngine(T_CFG, [TenantSpec(n, p) for n, p in plans.items()],
                        dlrm_extras=ex, device="cpu")
    assert len(eng.lanes) == 2
    eng.warmup()
    # corrupt one packed weight bit: lane a aborts its requests, lane b
    # logs the detection and completes them
    eng.params["bottom"][0]["w_packed"][2, 3] ^= 0x10
    tel = eng.run(_stream(dlrm_stream, ex, 6, {"a": 1.0, "b": 1.0}))
    per = tel.summary()["per_tenant"]
    assert per["a"]["aborted"] == per["a"]["requests"] > 0
    assert per["b"]["completed"] == per["b"]["requests"] > 0
    counters = tel.summary()["faults"]["counters"]
    assert counters["qgemm_errors"] > 0
    assert counters["embedding_bag_checks"] == 0


def test_engine_rejects_bad_payload_and_unported_family():
    ex = dataclasses.replace(T_EXTRAS, **_SMOKE)
    eng = ServingEngine(T_CFG, [TenantSpec("default")], dlrm_extras=ex,
                        device="cpu")
    req = _stream(dlrm_stream, ex, 1)[0]
    req.payload["bags"][0, 0, 0] = ex.table_rows          # past the table
    with pytest.raises(ValueError, match="bag index"):
        eng.run([req])
    with pytest.raises(NotImplementedError, match="not ported"):
        ServingEngine(dataclasses.replace(T_CFG, family="rnn"),
                      [TenantSpec("default")], device="cpu")


def test_serve_cli_smoke_on_cpu(tmp_path):
    out = tmp_path / "tel.json"
    assert serve.main(["--device", "cpu", "--smoke", "--requests", "4",
                       "--json", str(out)]) == 0
    tel = json.loads(out.read_text())
    assert tel["summary"]["per_tenant"]["default"]["completed"] == 4
    assert tel["summary"]["faults"]["counters"]["qgemm_checks"] == 20


@pytest.mark.parametrize("flag,item", [
    (["--arch", "mistral-large-123b", "--requests", "1"], 1),
    (["--arch", "llama4-scout-17b-a16e", "--requests", "1"], 1),
    (["--arch", "mistral-large-123b", "--plan", "*:off"], 2),
    (["--device-count", "2"], 2),
    (["--arch", "llama4-scout-17b-a16e"], 2),
    (["--device-count", "4", "--arch", "llama3.2-1b"], 2),
    (["--arch", "mistral-large-123b"], 2)])
def test_serve_cli_rejects_unported_parts(tmp_path, flag, item):
    """Nothing here is refused now: the two configs that outgrow one
    card at full depth serve reduced (``--smoke``), every request done
    with no error; ``--device-count N`` is accepted (any N on the CPU)
    and the run serves on the first device, as the JAX CLI does."""
    out = tmp_path / "tel.json"
    argv = ["--device", "cpu", "--smoke", "--json", str(out)] + flag
    if "--requests" not in flag:
        argv += ["--requests", "2"]
    assert serve.main(argv) == 0
    tel = json.loads(out.read_text())
    assert tel["summary"]["per_tenant"]["default"]["completed"] == item
    counters = tel["summary"]["faults"]["counters"]
    assert not any(v for k, v in counters.items() if "error" in k)


def test_serve_cli_device_count_needs_the_devices(capsys, monkeypatch):
    """On the card a ``--device-count`` above the cards there are exits
    with 2 (nothing falls back to fewer devices)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(SystemExit) as ei:
        serve.main(["--smoke", "--device-count", "2"])
    assert ei.value.code == 2
    assert "ROADMAP A8.1" in capsys.readouterr().err
