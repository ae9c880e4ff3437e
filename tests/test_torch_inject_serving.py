"""Weight-fault injection in the port's serving engine and CLI, on the CPU.

A :class:`FaultInjection` flips one bit of the victim leaf in place
before its global step: the step must be flagged, the leaf must be bit
for bit its clean self after a transient fault, and a persistent fault
must be flagged at every later step until :meth:`reset_state`.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.configs.dlrm import CONFIG as DLRM  # noqa: E402
from repro_torch.configs.dlrm import EXTRAS  # noqa: E402
from repro_torch.core.inject import leaf_paths  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.serving import (FaultInjection, Request,  # noqa: E402
                                 ServingEngine, TenantSpec, dlrm_stream)

_EX = dataclasses.replace(EXTRAS, table_rows=512, n_tables=4, emb_dim=32,
                          bottom_mlp=(64, 32), top_mlp=(64, 32, 1))


def _leaf(engine, path):
    return dict(leaf_paths(engine.params))[path]


def _dlrm():
    eng = ServingEngine(DLRM, [TenantSpec("default")], dlrm_extras=_EX,
                        device="cpu")
    # 0.01 requests/s of virtual time: one request per engine step
    stream = dlrm_stream(5, tenants={"default": 1.0}, rate_rps=0.01, seed=0,
                         lookup_batch=10, table_rows=_EX.table_rows,
                         n_tables=_EX.n_tables)
    return eng, stream


def test_transient_weight_flip_flagged_at_its_step_and_restored():
    eng, stream = _dlrm()
    leaf = _leaf(eng, "top.0.w_packed")
    clean = leaf.clone()
    tel = eng.run(stream, inject=[FaultInjection(step=2, victim="top.0",
                                                 seed=3)])
    (inj,) = tel.injections
    assert (inj.victim, inj.step, inj.detected, inj.detect_step) == \
        ("top.0.w_packed", 2, True, 2)
    assert [ev.step for ev in tel.steps if ev.errors] == [2]
    assert [ev.step for ev in tel.steps if ev.injected] == [2]
    assert torch.equal(leaf, clean)


def test_persistent_weight_flip_flagged_until_reset():
    eng, stream = _dlrm()
    leaf = _leaf(eng, "top.0.w_packed")
    clean = leaf.clone()
    tel = eng.run(stream, inject=[FaultInjection(
        step=1, victim="top.0", persistent=True, seed=4)])
    assert [ev.step for ev in tel.steps if ev.errors] == [1, 2, 3, 4]
    assert tel.injections[0].persistent
    assert int((leaf != clean).sum()) == 1
    eng.reset_state()
    assert torch.equal(leaf, clean) and eng.global_step == 0
    tel = eng.run(stream, warmup=False)
    assert not any(ev.errors for ev in tel.steps)


def test_kv_injection_waits_for_its_roadmap_item():
    """A KV-cache flip needs a resident quantized cache: a DLRM engine
    has none, so it takes no flip and records nothing (the LM lanes'
    flips: tests/test_torch_lm_serving.py)."""
    eng, stream = _dlrm()
    tel = eng.run(stream, inject=[FaultInjection(step=0, target="kv")])
    assert tel.injections == []
    assert not any(ev.errors for ev in tel.steps)
    with pytest.raises(ValueError, match="unknown injection target"):
        eng.run(stream, inject=[FaultInjection(step=0, target="cache")])
    with pytest.raises(ValueError, match="matches no leaf"):
        eng.run(stream, inject=[FaultInjection(step=0, victim="attn.wq")])


def test_rwkv_weight_flip_flagged_and_restored():
    cfg = reduce_cfg(get_arch("rwkv6-1.6b"))
    eng = ServingEngine(cfg, [TenantSpec("default")], max_prompt=24,
                        device="cpu")
    leaf = _leaf(eng, "layers.cm.wv.w_packed")
    clean = leaf.clone()
    # request 0 takes steps 0 and 1 (its prefill and two decodes), and
    # request 1's prefill runs at step 2
    reqs = [Request(rid=i, tenant="default", arrival_s=100.0 * i,
                    prompt_len=24, max_new_tokens=3, seed=i)
            for i in range(2)]
    tel = eng.run(reqs, inject=[FaultInjection(step=2, victim="cm.wv")])
    (inj,) = tel.injections
    assert [(ev.step, ev.kind) for ev in tel.steps if ev.injected] == \
        [(2, "prefill"), (2, "decode")]
    assert inj.detected and inj.detect_step == 2
    assert all(ev.errors == 0 for ev in tel.steps if ev.step != 2)
    assert torch.equal(leaf, clean)


def test_serve_cli_injects_a_weight_flip(tmp_path):
    out = tmp_path / "tel.json"
    assert serve.main(["--device", "cpu", "--smoke", "--requests", "4",
                       "--rate", "0.01", "--inject-step", "2",
                       "--inject-victim", "top.0", "--json",
                       str(out)]) == 0
    tel = json.loads(out.read_text())
    (inj,) = tel["summary"]["faults"]["injections"]
    assert inj["step"] == 2 and inj["detected"]
    assert inj["latency_steps"] == 0
    counters = tel["summary"]["faults"]["counters"]
    assert counters["qgemm_errors"] > 0
