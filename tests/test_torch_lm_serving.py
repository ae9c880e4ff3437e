"""The port's serving engine, CLI and campaign targets on the smoke
Llama-3.2-1B, on the CPU, against the JAX package.

The JAX engine runs its steps op by op (``jax.disable_jit``): then its
quantizers divide as the port's do (ROADMAP §C5) and both engines give
the same tokens, counters and KV-flip draws on the same seeded stream.
The campaign cells are compared by Wilson interval: the two packages
draw their faults from different generators.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax  # noqa: E402

from repro.campaign import executor as j_executor  # noqa: E402
from repro.campaign import spec as j_spec  # noqa: E402
from repro.configs.reduce import small_arch  # noqa: E402
from repro.protect import default_plan as j_default_plan  # noqa: E402
from repro.protect.plan import ProtectionPlan as JPlan  # noqa: E402
from repro.serving import FaultInjection as JFault  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import TenantSpec as JTenant  # noqa: E402
from repro.serving import chat_stream as j_chat_stream  # noqa: E402
from repro_torch.campaign import spec  # noqa: E402
from repro_torch.campaign.diff import wilson_gate  # noqa: E402
from repro_torch.campaign.executor import run_campaign  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.core import QuantKV  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.protect import ProtectionPlan, default_plan  # noqa: E402
from repro_torch.serving import (FaultInjection, Request,  # noqa: E402
                                 ServingEngine, TenantSpec, chat_stream)

J_CFG = small_arch("llama3.2-1b")
T_CFG = reduce_cfg(get_arch("llama3.2-1b"))
_KV_PLAN = "*:policy=recompute,kv_cache:on"


def _stream(fn, n=4):
    # at 1e6 requests/s every arrival lands within microseconds, inside
    # one engine step on either package, so both engines batch the same
    # requests into the same steps whatever their speed
    return fn(n, tenants={"a": 1.0, "b": 1.0}, rate_rps=1e6, seed=0,
              mean_prompt=12, max_prompt=24, mean_output=4, max_output=6)


def _tenants(plan_cls, default, spec_cls):
    kv = default().with_rules(*plan_cls.from_any(_KV_PLAN).rules)
    return [spec_cls("a", default()),
            spec_cls("b", dataclasses.replace(kv, name="b"))]


def test_engine_matches_jax_engine_with_a_kv_flip():
    # seed 0 draws the quantized lane (b) for the KV flip, in both
    # engines (the same numpy draws)
    j_eng = JEngine(J_CFG, _tenants(JPlan, j_default_plan, JTenant),
                    max_prompt=24, max_new_tokens=6)
    with jax.disable_jit():
        j_tel = j_eng.run(_stream(j_chat_stream),
                          inject=[JFault(step=3, target="kv", seed=0)])
    eng = ServingEngine(T_CFG, _tenants(ProtectionPlan, default_plan,
                                        TenantSpec),
                        max_prompt=24, max_new_tokens=6, device="cpu")
    assert eng.cache_len == j_eng.cache_len == 24 + 6 + 8
    eng.params = from_jax(jax.tree.map(np.asarray, j_eng.params),
                          device="cpu")
    tel = eng.run(_stream(chat_stream),
                  inject=[FaultInjection(step=3, target="kv", seed=0)])

    assert {r.rid: r.tokens for r in tel.requests} == \
        {r.rid: r.tokens for r in j_tel.requests}
    assert [(e.step, e.kind, e.lane, e.slot_rids, e.errors)
            for e in tel.steps] == \
        [(e.step, e.kind, e.lane, e.slot_rids, e.errors)
         for e in j_tel.steps]
    counters = tel.summary()["faults"]["counters"]
    j_counters = j_tel.summary()["faults"]["counters"]
    assert all(j_counters[k] == 0 for k in set(j_counters) - set(counters))
    assert counters == {k: j_counters[k] for k in counters}
    (inj,), (j_inj,) = tel.injections, j_tel.injections
    assert (inj.step, inj.victim, inj.detected, inj.detect_step) == \
        (j_inj.step, j_inj.victim, j_inj.detected, j_inj.detect_step)
    assert inj.victim.startswith("kv_row/") and inj.persistent
    # flagged at the next decode step, once a read, until the slot leaves
    flagged = [e for e in tel.steps if e.errors]
    assert inj.detect_step == 3 == flagged[0].step
    assert all(e.kind == "decode" and e.lane.endswith("[b]")
               and e.counters["kv_cache_errors"] == 1 for e in flagged)
    assert counters["kv_cache_checks"] == 2 * sum(
        e.kind == "decode" and e.lane.endswith("[b]") for e in tel.steps)


def _engine(plan_text, **kw):
    plan = default_plan().with_rules(
        *ProtectionPlan.from_any(plan_text).rules)
    return ServingEngine(T_CFG, [TenantSpec("default", plan)],
                         max_prompt=16, max_new_tokens=8, device="cpu", **kw)


def _request(rid, seed, new=6, at=0.0):
    return Request(rid=rid, tenant="default", arrival_s=at, prompt_len=16,
                   max_new_tokens=new, seed=seed)


def test_kv_flip_persists_until_the_slot_is_refilled():
    eng = _engine(_KV_PLAN, n_slots=1)
    # request 0 takes steps 0-4 (prefill + decode, then 4 decodes);
    # request 1 arrives later and refills the one slot
    reqs = [_request(0, 1), _request(1, 2, at=1e3)]
    tel = eng.run(reqs, inject=[FaultInjection(step=1, target="kv",
                                               seed=3)])
    (inj,) = tel.injections
    flagged = sorted({e.step for e in tel.steps if e.errors})
    assert inj.detected and inj.detect_step == 1
    assert flagged == [1, 2, 3, 4]
    assert all(e.counters["kv_cache_errors"] == 1 for e in tel.steps
               if e.errors)
    # the refill wrote every row of the slot, rowsums included
    assert not any(e.errors for e in tel.steps
                   if 1 in e.slot_rids)
    lane = eng.lanes[0]
    assert isinstance(lane.cache["attn"]["k"], QuantKV)
    eng.reset_state()
    assert lane.cache is None
    tel = eng.run([_request(2, 1)], warmup=False)
    assert not any(e.errors for e in tel.steps)


def test_bf16_lane_takes_no_kv_flip_and_weight_flip_is_flagged():
    eng = _engine("*:policy=log")
    tel = eng.run([_request(0, 1)], inject=[FaultInjection(
        step=1, target="kv", seed=0)])
    assert tel.injections == [] and not any(e.errors for e in tel.steps)
    assert not isinstance(eng.lanes[0].cache["attn"]["k"], QuantKV)
    leaf = eng.params["layers"]["attn"]["wq"]["w_packed"]
    clean = leaf.clone()
    eng.reset_state()
    tel = eng.run([_request(1, 2)], inject=[FaultInjection(
        step=2, victim="attn.wq", seed=0)], warmup=False)
    (inj,) = tel.injections
    assert inj.victim == "layers.attn.wq.w_packed"
    assert inj.detected and inj.detect_step == 2
    assert [e.step for e in tel.steps if e.errors] == [2]
    assert torch.equal(leaf, clean)


@pytest.mark.parametrize("argv", [
    [], ["--plan", _KV_PLAN], ["--inject-step", "2",
                                "--inject-victim", "attn.wq"]])
def test_serve_cli_serves_llama_on_cpu(tmp_path, capsys, caplog, argv):
    import json
    import logging
    out = tmp_path / "tel.json"
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        assert serve.main(["--arch", "llama3.2-1b", "--device", "cpu",
                           "--smoke", "--requests", "4", "--json",
                           str(out)] + argv) == 0
    s = json.loads(out.read_text())["summary"]
    per = s["per_tenant"]["default"]
    assert per["completed"] == 4 and per["aborted"] == 0
    counters = s["faults"]["counters"]
    assert counters["qgemm_checks"] == 15 * s["steps"]
    assert (counters["kv_cache_checks"] > 0) == ("--plan" in argv)
    if "--inject-step" in argv:
        assert "injected layers.attn.wq.w_packed at step 2: DETECTED" \
            in caplog.text
    else:
        assert counters["qgemm_errors"] == counters["kv_cache_errors"] == 0


def test_serve_cli_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "llama3.2-1b", "--smoke", "--requests", "1"])


def _gate_against_jax(kw):
    t_res = run_campaign("t", [spec.CampaignSpec(**kw)], device="cpu")
    j_res = j_executor.run_campaign("j", [j_spec.CampaignSpec(**kw)])
    gate = wilson_gate(j_res, t_res)
    assert gate["uncovered"] == [] and gate["failed"] == [], gate
    return t_res, j_res


def test_kv_cache_cells_overlap_jax():
    t_res, j_res = _gate_against_jax(dict(
        name="kv", targets=("kv_cache",),
        fault_models=("bitflip", "random_value"), bit_bands=("all", "low"),
        dtypes=("int8", "float32"), samples=100, clean_samples=20,
        seed=3))
    assert len(t_res["cells"]) == len(j_res["cells"]) == 6
    for c in t_res["cells"]:
        m = c["metrics"]
        if c["plan"]["dtype"] == "int8" and \
                c["plan"]["fault_model"] == "bitflip":
            assert m["raw_detection_rate"] == 1.0
        if c["plan"]["dtype"] == "float32":
            assert m["raw_detection_rate"] == 0.0


def test_decode_soak_cell_overlaps_jax():
    t_res, _ = _gate_against_jax(dict(
        name="soak", targets=("decode_step",), fault_models=("bitflip",),
        bit_bands=("significant",), victims=("attn.wq",), steps=2,
        persistent=(True,), samples=4, clean_samples=2, seed=0))
    (c,) = t_res["cells"]
    assert c["cell_id"].endswith("/vic=attn.wq/steps2/persistent")
    m = c["metrics"]
    assert m["steps"] == 2 and len(m["detection_latency_hist"]) == 2
    assert sum(m["detection_latency_hist"]) == m["detected"]
    assert m["false_positives"] == 0


def test_decode_step_plain_run_is_the_cpu_run():
    # the model has no switch to its plain ops, so plain=True on a CUDA
    # device is refused before anything reaches the device
    import torch

    from repro_torch.campaign.targets import get_target

    plan = spec.CellPlan(
        cell_id="decode_step/plain", target="decode_step",
        fault_model="bitflip", bit_band="significant", shape=(1, 8),
        dtype="int8", samples=1, clean_samples=0, flips=1, seed=0,
        measure_overhead=False)
    with pytest.raises(ValueError, match="plain run is the CPU run"):
        get_target("decode_step").build(plan, torch.Generator(),
                                        device="cuda", plain=True)
