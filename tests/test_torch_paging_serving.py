"""The port's paged decode path, paged serving engine, serve CLI and
``paging`` grid against the JAX package, on the CPU.

* the paged ``attention_decode`` and the reduced Llama-3.2-1B's
  ``lm_decode`` over stacked page pools, against the JAX functions run op
  by op (``jax.disable_jit``, ROADMAP §C5): the pools' codes and
  pagesums and the reports' counts bit-exact, the affine parameters
  within the LM tests' tolerances (float32 1e-5, bfloat16 2**-8 of the
  scale; ``tests/test_torch_lm.py``), the outputs within 1e-5 (float32)
  and the LM tests' 2**-5 for a bf16 rounding split (bfloat16);
* the paged engine against the JAX paged engine on the same weights and
  a stream whose requests all arrive before the first step: the same
  steps, counters, paging stats, KV-flip victims and flagged steps, and
  the same greedy tokens.  The JAX engine runs jitted (op by op it takes
  minutes): its quantizers then multiply by the reciprocal of 255
  (§C5), which moves no token of these bf16 runs (measured), so tokens
  are held equal;
* ``--paged-kv 8 --kv-pages 64`` through the serve CLI;
* ``--grid paging --quick --device cpu`` against the committed
  ``BENCH_campaign_paging_quick.json`` by Wilson overlap, the port's
  differ and the cells' four booleans.
"""
import json
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import paging as jp  # noqa: E402
from repro.configs.reduce import small_arch  # noqa: E402
from repro.layers import attention as j_att  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.protect import default_plan as j_default_plan  # noqa: E402
from repro.protect.plan import ProtectionPlan as JPlan  # noqa: E402
from repro.serving import FaultInjection as JFault  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import TenantSpec as JTenant  # noqa: E402
from repro.serving import chat_stream as j_chat_stream  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch import paging as tp  # noqa: E402
from repro_torch.campaign import __main__ as cli  # noqa: E402
from repro_torch.campaign.diff import run_diff, wilson_gate  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.layers import attention as t_att  # noqa: E402
from repro_torch.layers.common import Ctx as TCtx  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.protect import ProtectionPlan, default_plan  # noqa: E402
from repro_torch.serving import (FaultInjection, ServingEngine,  # noqa: E402
                                 TenantSpec, chat_stream)

J_CFG = small_arch("llama3.2-1b")
T_CFG = reduce_cfg(get_arch("llama3.2-1b"))
_TOL = {"float32": 1e-5, "bfloat16": 2.0**-8}
#: a layer's or the model's output: the attention's float32 sums run in
#: another order than XLA's, and where the bf16 run rounds the attention
#: output to bf16 (then to int8 codes for attn.wo) a last-bit difference
#: can land across a rounding split; such runs take the LM tests'
#: allowance for a split (tests/test_torch_lm.py, _SPLIT_TOL)
_OUT_TOL = {"float32": 1e-5, "bfloat16": 2.0**-5}
_PAGED = "*:policy=log,kv_cache_paged:on"
_REBUILD = "*:policy=recompute,kv_cache_paged:on"
_BASELINE = "benchmarks/baselines/BENCH_campaign_paging_quick.json"


def _scaled_err(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _metrics(rep):
    return {k: int(v) for k, v in rep.as_metrics().items()}


def _same_metrics(tm, jm):
    # other test modules may register extra JAX op kinds in this process;
    # those keys stay zero
    assert set(tm) <= set(jm)
    assert all(jm[k] == 0 for k in set(jm) - set(tm))
    assert tm == {k: jm[k] for k in tm}


def _ctxs(dtype, plan_text):
    return (JCtx(quant=True, compute_dtype=getattr(jnp, dtype),
                 plan=j_default_plan().with_rules(
                     *JPlan.from_any(plan_text).rules)),
            TCtx(quant=True, compute_dtype=getattr(torch, dtype),
                 plan=default_plan().with_rules(
                     *ProtectionPlan.from_any(plan_text).rules)))


def _t(pool):
    """A JAX pool as the port's, on writable CPU tensors."""
    return tp.PagedKV(*(torch.from_numpy(np.array(x)) for x in pool))


def _pools_equal(tc, jc, dtype):
    """Codes, pagesums and the table bit-exact; the affine parameters
    within the dtype's tolerance (they come from float K/V rows)."""
    for name in ("k", "v"):
        t, j = tc[name], jc[name]
        for f in ("q", "pagesum", "table"):
            np.testing.assert_array_equal(getattr(t, f).numpy(),
                                          np.asarray(getattr(j, f)),
                                          err_msg=f"{name}.{f}")
        for f in ("alpha", "beta"):
            assert _scaled_err(getattr(t, f), getattr(j, f)) \
                <= _TOL[dtype], f"{name}.{f}"


def _stacked_pools(rng, n_layers, *, kv, dh, p=8, n_pages=10, n_slots=3,
                   max_pages=4):
    """JAX K and V pools (stacked) with two slots' prompts packed: slot 0
    on pages [4, 2] with tail page 7, slot 1 on [2, 5] (page 2 shared)
    with tail page 0, slot 2 unmapped."""
    pools = []
    for _ in range(2):
        pool = jp.paged_pool(n_pages, kv, p, dh, n_slots, max_pages,
                             n_layers=n_layers)
        for ids in ([4, 2], [2, 5]):
            src = rng.standard_normal((n_layers, 1, kv, 2 * p, dh))
            pool = jp.pack_prompt_pages(
                pool, jnp.asarray(src, jnp.float32),
                jnp.asarray(ids, jnp.int32))
        pool = jp.reset_pages(pool, jnp.asarray([7, 0, 10], jnp.int32))
        tbl = np.full((n_slots, max_pages), -1, np.int32)
        tbl[0, :3] = [4, 2, 7]
        tbl[1, :3] = [2, 5, 0]
        pools.append(pool._replace(table=jnp.broadcast_to(
            jnp.asarray(tbl), (n_layers,) + tbl.shape)))
    return {"k": pools[0], "v": pools[1]}


def _layer(tree, i):
    return {k: type(v)(*(x[i] for x in v)) for k, v in tree.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_attention_decode_matches_jax(dtype):
    cfg = J_CFG
    w = values_of(j_att.init_attention(
        jax.random.key(1), cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim_, quant=True))
    w = jax.tree.map(np.asarray, w)
    rng = np.random.default_rng(2)
    jc = _layer(_stacked_pools(rng, 1, kv=cfg.n_kv_heads,
                               dh=cfg.head_dim_), 0)
    tc = {k: _t(v) for k, v in jc.items()}
    jctx, tctx = _ctxs(dtype, _PAGED)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta)
    tparams = from_jax(w, device="cpu")
    # slots 0 and 1 append at the start of their tail pages, then one
    # step further; slot 2 (unmapped) drops its writes
    pos = np.array([16, 16, 16], np.int32)
    for step in range(3):
        if step == 2:                  # a flip in the shared prompt page
            jc = {**jc, "k": jc["k"]._replace(
                q=jc["k"].q.at[2, 1, 3, 5].set(jc["k"].q[2, 1, 3, 5] ^ 32))}
            tc["k"].q[2, 1, 3, 5] ^= 32
        x1 = rng.standard_normal((3, cfg.d_model)).astype(np.float32)
        with jax.disable_jit():
            jy, jc, jr = j_att.attention_decode(
                jax.tree.map(jnp.asarray, w),
                jnp.asarray(x1).astype(jctx.compute_dtype), jc,
                jnp.asarray(pos), jctx, **kw)
        ty, tc, tr = t_att.attention_decode(
            tparams, torch.from_numpy(x1).to(tctx.compute_dtype), tc,
            torch.from_numpy(pos), tctx, **kw)
        assert ty.dtype == tctx.compute_dtype
        assert _scaled_err(ty.float(), jy) <= _OUT_TOL[dtype]
        _same_metrics(_metrics(tr), _metrics(jr))
        tm = _metrics(tr)
        # touched: 3 pages a mapped slot, both pools
        assert tm["abft/kv_cache_paged_checks"] == 2 * 2 * 3
        assert tm["abft/kv_cache_paged_errors"] == (2 if step == 2 else 0)
        _pools_equal(tc, jc, dtype)
        pos = pos + 1


@pytest.fixture(scope="module")
def weights():
    return jax.tree.map(np.asarray, values_of(jax.jit(
        lambda k: j_lm.init_lm(k, J_CFG, quant=True))(jax.random.key(0))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_paged_llama_decode_matches_jax(weights, dtype):
    jctx, tctx = _ctxs(dtype, _PAGED)
    jparams = jax.tree.map(jnp.asarray, weights)
    tparams = from_jax(weights, device="cpu")
    rng = np.random.default_rng(9)
    jc = {"attn": _stacked_pools(rng, J_CFG.n_layers, kv=J_CFG.n_kv_heads,
                                 dh=J_CFG.head_dim_)}
    tc = {"attn": {k: _t(v) for k, v in jc["attn"].items()}}
    storage = {k: v.q.data_ptr() for k, v in tc["attn"].items()}
    tokens = rng.integers(0, J_CFG.vocab, 3).astype(np.int32)
    pos = np.array([16, 16, 16], np.int32)
    for _ in range(4):
        with jax.disable_jit():
            jl, jc, jr = j_lm.lm_decode(jparams, jc, jnp.asarray(tokens),
                                        jnp.asarray(pos), jctx, J_CFG)
        tl, tc, tr = t_lm.lm_decode(tparams, tc, torch.from_numpy(tokens),
                                    torch.from_numpy(pos), tctx, T_CFG)
        assert _scaled_err(tl.float(), jl) <= _OUT_TOL[dtype]
        _same_metrics(_metrics(tr), _metrics(jr))
        _pools_equal(tc["attn"], jc["attn"], dtype)
        # the pools were written in place: a decode step copies none
        assert {k: v.q.data_ptr() for k, v in tc["attn"].items()} \
            == storage
        tokens = np.argmax(np.asarray(jl, np.float32)[:, :J_CFG.vocab],
                           -1).astype(np.int32)
        pos = pos + 1
    assert _metrics(tr)["abft/kv_cache_paged_checks"] == \
        J_CFG.n_layers * 2 * 2 * 3


# ------------------------------ the engine ----------------------------------

def _engine_stream(fn):
    # at 1e6 requests/s every arrival lands inside the first engine step
    # on either package, so both engines batch the same requests into the
    # same steps whatever their speed
    return fn(4, tenants={"a": 1.0, "b": 1.0}, rate_rps=1e6, seed=3,
              mean_prompt=20, max_prompt=24, mean_output=4, max_output=6,
              prefix_len=8, prefix_seed=77)


def _engines(plan_text, weights_of=None):
    j_plan = JPlan.parse(plan_text, name="p")
    je = JEngine(J_CFG, [JTenant("a", j_plan), JTenant("b", j_plan)],
                 n_slots=2, max_prompt=24, max_new_tokens=6,
                 paging=jp.PagingConfig(page_size=8, n_pages=12))
    t_plan = ProtectionPlan.parse(plan_text, name="p")
    te = ServingEngine(T_CFG, [TenantSpec("a", t_plan),
                               TenantSpec("b", t_plan)],
                       n_slots=2, max_prompt=24, max_new_tokens=6,
                       paging=tp.PagingConfig(page_size=8, n_pages=12),
                       device="cpu")
    te.params = from_jax(jax.tree.map(np.asarray, je.params), device="cpu")
    return je, te


@pytest.mark.parametrize("plan_text,step,seed", [
    (_PAGED, 2, 4), (_REBUILD, 3, 7)])
def test_paged_engine_matches_the_jax_engine(plan_text, step, seed):
    je, te = _engines(plan_text)
    assert te.cache_len == je.cache_len == 24 + 6 + 8
    jt = je.run(_engine_stream(j_chat_stream), inject=[JFault(
        step=step, target="kv", persistent=True, seed=seed)])
    tt = te.run(_engine_stream(chat_stream), inject=[FaultInjection(
        step=step, target="kv", persistent=True, seed=seed)])
    assert {r.rid: (r.tokens, r.aborted, r.prefill_tokens,
                    r.shared_prefix_tokens) for r in tt.requests} == \
        {r.rid: (r.tokens, r.aborted, r.prefill_tokens,
                 r.shared_prefix_tokens) for r in jt.requests}
    assert [(e.step, e.kind, e.lane, e.slot_rids, e.errors, e.occupancy)
            for e in tt.steps] == \
        [(e.step, e.kind, e.lane, e.slot_rids, e.errors, e.occupancy)
         for e in jt.steps]
    counters = tt.summary()["faults"]["counters"]
    j_counters = jt.summary()["faults"]["counters"]
    assert all(j_counters[k] == 0 for k in set(j_counters) - set(counters))
    assert counters == {k: j_counters[k] for k in counters}
    assert te.paging_stats() == je.paging_stats()
    (inj,), (j_inj,) = tt.injections, jt.injections
    assert (inj.step, inj.victim, inj.detected, inj.detect_step) == \
        (j_inj.step, j_inj.victim, j_inj.detected, j_inj.detect_step)
    assert inj.victim.startswith("kv_page/") and inj.detect_step == step
    st = next(iter(te.paging_stats().values()))
    assert counters["kv_cache_paged_checks"] > 0
    assert st["prefix_hits"] > 0
    per = tt.summary()["per_tenant"]
    assert sum(t["aborted"] for t in per.values()) == 0
    assert sum(t["shared_prefix_tokens"] for t in per.values()) > 0
    flagged = [e for e in tt.steps if e.errors]
    if plan_text == _PAGED:
        # log: flagged at the next decode step and at each later read
        assert len(flagged) > 1 and st["page_rebuilds"] == 0
        assert all(e.kind == "decode" for e in flagged)
    else:
        # recompute: flagged once, the page evicted and rebuilt
        assert [e.step for e in flagged] == [step]
        assert st["page_rebuilds"] >= 1
        assert any(e.kind == "rebuild" for e in tt.steps)
        # a clean pass afterwards: no errors
        te.reset_state()
        clean = te.run(_engine_stream(chat_stream), warmup=False)
        assert not any(e.errors for e in clean.steps)


def test_paged_warmup_leaves_the_lane_pools_as_it_found_them():
    """The warm-up writes a synthetic prompt and a decode row into a new
    lane's own pools and zeroes them after; a lane that already holds
    pages warms up on throwaway pools and keeps its own bit for bit."""
    te = ServingEngine(T_CFG, [TenantSpec("a", ProtectionPlan.parse(
                           _PAGED, name="p"))], n_slots=2, max_prompt=24,
                       max_new_tokens=6, device="cpu",
                       paging=tp.PagingConfig(page_size=8, n_pages=12))
    te.warmup()
    (lane,) = te.lanes
    for leaf in lane.cache["attn"].values():
        assert all(int(t.count_nonzero()) == 0 for t in leaf[:4])
    assert bool((lane.table == -1).all())
    tt = te.run(_engine_stream(chat_stream), warmup=False)
    assert len(tt.requests) == 4 and not any(e.errors for e in tt.steps)

    te2 = ServingEngine(T_CFG, [TenantSpec("a", ProtectionPlan.parse(
                            _PAGED, name="p"))], n_slots=2, max_prompt=24,
                        max_new_tokens=6, device="cpu",
                        paging=tp.PagingConfig(page_size=8, n_pages=12))
    te2.run(_engine_stream(chat_stream)[:1], warmup=False)
    (lane2,) = te2.lanes
    before = [t.clone() for leaf in lane2.cache["attn"].values()
              for t in leaf[:4]] + [lane2.table.clone()]
    assert int(before[0].count_nonzero()) > 0
    te2.warmup()
    after = [t for leaf in lane2.cache["attn"].values()
             for t in leaf[:4]] + [lane2.table]
    assert all(torch.equal(a, b) for a, b in zip(after, before))


def test_paged_engine_refuses_what_jax_refuses():
    import dataclasses
    with pytest.raises(ValueError, match="cannot hold even one"):
        ServingEngine(T_CFG, [TenantSpec("a")], n_slots=2, max_prompt=32,
                      max_new_tokens=8, device="cpu",
                      paging=tp.PagingConfig(page_size=8, n_pages=2))
    meta = dataclasses.replace(T_CFG, meta_tokens=1)
    with pytest.raises(ValueError, match="meta_tokens"):
        ServingEngine(meta, [TenantSpec("a")], n_slots=2, max_prompt=32,
                      max_new_tokens=8, device="cpu",
                      paging=tp.PagingConfig(page_size=8, n_pages=64))
    with pytest.raises(ValueError, match="attention-only"):
        ServingEngine(reduce_cfg(get_arch("rwkv6-1.6b")), [TenantSpec("a")],
                      device="cpu", paging=tp.PagingConfig())


def test_serve_cli_serves_paged_llama_on_cpu(tmp_path, caplog):
    out = tmp_path / "tel.json"
    with caplog.at_level(logging.INFO, logger="repro_torch.serve"):
        assert serve.main([
            "--arch", "llama3.2-1b", "--device", "cpu", "--smoke",
            "--requests", "4", "--paged-kv", "8", "--kv-pages", "64",
            "--plan", _REBUILD, "--json", str(out)]) == 0
    s = json.loads(out.read_text())["summary"]
    per = s["per_tenant"]["default"]
    assert per["completed"] == 4 and per["aborted"] == 0
    counters = s["faults"]["counters"]
    assert counters["kv_cache_paged_checks"] > 0
    assert counters["kv_cache_paged_errors"] == counters["kv_cache_checks"] \
        == 0
    assert "paging lane0[default]: resident=" in caplog.text


def test_paging_grid_quick_overlaps_the_jax_baseline(tmp_path, capsys):
    assert cli.main(["--grid", "paging", "--quick", "--device", "cpu",
                     "--out", str(tmp_path)]) == 0
    path = tmp_path / "BENCH_campaign_paging_quick.json"
    res = json.loads(path.read_text())
    with open(_BASELINE) as f:
        base = json.load(f)
    assert res["campaign"] == base["campaign"] == "paging_quick"
    assert res["specs"] == base["specs"]
    assert [c["plan"] for c in res["cells"]] == \
        [c["plan"] for c in base["cells"]]
    gate = wilson_gate(base, res)
    assert gate["failed"] == [] and gate["uncovered"] == [], gate
    parity, rebuild = (c["metrics"] for c in res["cells"])
    assert parity["parity_ok"] and parity["verify_ok"] and \
        parity["bytes_ok"] and rebuild["rebuild_ok"]
    assert rebuild["aborted"] == 0
    # the fixed-slot layout's bytes depend on shapes only; the pool's
    # peak is 28 pages at most
    assert parity["fixed_slot_kv_bytes"] == 50176
    assert 0 < parity["peak_resident_kv_bytes"] <= 43904
    capsys.readouterr()
    assert run_diff(_BASELINE, str(path)) == 0

