"""The port's serving engine and CLI on the smoke RWKV6, on the CPU,
against the JAX engine on the same seeded chat stream and weights."""
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.protect  # noqa: E402
from repro.configs.reduce import small_arch  # noqa: E402
from repro.protect import default_plan as j_default_plan  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import TenantSpec as JTenant  # noqa: E402
from repro.serving import chat_stream as j_chat_stream  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.protect import default_plan  # noqa: E402
from repro_torch.serving import ServingEngine, TenantSpec  # noqa: E402
from repro_torch.serving import chat_stream  # noqa: E402

J_CFG = small_arch("rwkv6-1.6b")
T_CFG = reduce_cfg(get_arch("rwkv6-1.6b"))


def _stream(fn, n=4, rate=1e6):
    # at 1e6 requests/s every arrival lands within microseconds, far
    # inside one engine step on either package, so the two engines batch
    # the same requests into the same steps whatever their speed
    return fn(n, tenants={"default": 1.0}, rate_rps=rate, seed=0,
              mean_prompt=16, max_prompt=32, mean_output=4, max_output=8)


def test_chat_stream_is_the_jax_stream():
    for t, j in zip(_stream(chat_stream, 8, 100.0),
                    _stream(j_chat_stream, 8, 100.0)):
        assert (t.rid, t.tenant, t.arrival_s, t.kind, t.prompt_len,
                t.max_new_tokens, t.seed) == \
            (j.rid, j.tenant, j.arrival_s, j.kind, j.prompt_len,
             j.max_new_tokens, j.seed)


def test_engine_matches_jax_engine_tokens_and_counters(monkeypatch):
    # the port's lanes run the chunked WKV prefill (cfg.wkv_chunk); bind
    # the JAX engine's lanes to the same chunk through the protect() it
    # imports at lane-build time
    plain_protect = repro.protect.protect

    def protect_with_chunk(fn, plan, **kw):
        return plain_protect(fn, plan, wkv_chunk=J_CFG.wkv_chunk, **kw)

    monkeypatch.setattr(repro.protect, "protect", protect_with_chunk)
    # float32 compute: in bf16 a last-bit difference between the two
    # packages can move an int8 code and, rarely, a greedy token
    j_eng = JEngine(J_CFG, [JTenant("default", j_default_plan())],
                    max_prompt=32, max_new_tokens=8,
                    compute_dtype=jnp.float32)
    j_tel = j_eng.run(_stream(j_chat_stream))

    eng = ServingEngine(T_CFG, [TenantSpec("default", default_plan())],
                        max_prompt=32, compute_dtype=torch.float32,
                        device="cpu")
    eng.params = from_jax(jax.tree.map(np.asarray, j_eng.params),
                          device="cpu")
    tel = eng.run(_stream(chat_stream))

    s, j_s = tel.summary(), j_tel.summary()
    assert s["per_tenant"]["default"]["completed"] == 4
    assert s["per_tenant"]["default"]["aborted"] == 0
    assert {r.rid: r.tokens for r in tel.requests} == \
        {r.rid: r.tokens for r in j_tel.requests}
    assert [r.tokens_out for r in sorted(tel.requests, key=lambda r: r.rid)]\
        == [r.max_new_tokens for r in _stream(chat_stream)]
    assert [(e.kind, e.slot_rids) for e in tel.steps] == \
        [(e.kind, e.slot_rids) for e in j_tel.steps]
    counters, j_counters = s["faults"]["counters"], j_s["faults"]["counters"]
    # other test modules may register extra JAX op kinds in this process
    assert all(j_counters[k] == 0 for k in set(j_counters) - set(counters))
    assert counters == {k: j_counters[k] for k in counters}
    steps = len(tel.steps)
    assert counters["qgemm_checks"] == 15 * steps
    assert counters["embedding_bag_checks"] == steps
    assert counters["qgemm_errors"] == counters["embedding_bag_errors"] == 0


def test_engine_abort_policy_fails_the_lane_and_keeps_serving():
    from repro_torch.protect import ProtectionPlan
    eng = ServingEngine(T_CFG, [TenantSpec(
        "default", ProtectionPlan.parse("*:policy=abort"))],
        max_prompt=32, device="cpu")
    eng.warmup()
    # a flipped payload bit of the head's packed weight: every step aborts
    eng.params["head"]["w_packed"][3, 5] ^= 0x10
    tel = eng.run(_stream(chat_stream), warmup=False)
    per = tel.summary()["per_tenant"]["default"]
    assert per["aborted"] == per["requests"] == 4
    assert all(ev.errors == 1 for ev in tel.steps)


def test_engine_refuses_mismatched_requests_and_missing_card(monkeypatch):
    eng = ServingEngine(T_CFG, [TenantSpec("default")], max_prompt=32,
                        device="cpu")
    from repro_torch.serving import dlrm_stream
    with pytest.raises(ValueError, match="does not serve 'dlrm'"):
        eng.run(dlrm_stream(1, tenants={"default": 1.0}))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine(T_CFG, [TenantSpec("default")])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        serve.main(["--arch", "rwkv6-1.6b", "--smoke", "--requests", "1"])


# The chunked WKV form and the per-token recurrence are one computation
# summed in two orders: in float32 they differ in the last bits, and a
# last-bit difference can round an activation to the neighbouring int8
# code downstream (the allowance of tests/test_torch_rwkv.py).  Measured
# here: timemix y within 2.9e-6 of its scale at S = 24 and 3.2e-3 at
# S = 40 (one such rounding), the state within 6.3e-7, the engine's
# prefill logits within 2.3e-5.  A lost or doubled chunk or tail token
# moves the outputs by more than their scale.
_OFF_GRID_TOL = 2.0**-5


def _scaled_err(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("s", [24, 40])
def test_timemix_off_the_chunk_grid_matches_the_jax_recurrence(s):
    from repro.layers import rwkv6 as j_rk
    from repro.layers.common import Ctx as JCtx
    from repro.sharding import values_of
    from repro_torch.layers import rwkv6 as t_rk
    from repro_torch.layers.common import Ctx as TCtx

    d, h = J_CFG.d_model, J_CFG.n_heads
    tm = jax.tree.map(np.asarray, values_of(j_rk.init_timemix(
        jax.random.key(6), d, h, quant=True)))
    rng = np.random.default_rng(s)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    x_prev = rng.standard_normal((2, d)).astype(np.float32)
    s0 = (rng.standard_normal((2, h, d // h, d // h)) * 0.1).astype(
        np.float32)
    # the JAX engine's serving context: wkv_chunk 0, the recurrence alone
    jctx = JCtx(quant=True, compute_dtype=jnp.float32)
    jy, _, js, jrep = jax.jit(lambda *a: j_rk.timemix(*a, jctx, n_heads=h))(
        jax.tree.map(jnp.asarray, tm), jnp.asarray(x), jnp.asarray(x_prev),
        jnp.asarray(s0))
    calls = []
    real = t_rk.wkv_chunked

    def chunked(*a, **kw):
        calls.append(a[0].shape[1])
        return real(*a, **kw)

    t_rk.wkv_chunked = chunked
    try:
        ty, _, ts, trep = t_rk.timemix(
            from_jax(tm, device="cpu"), torch.from_numpy(x),
            torch.from_numpy(x_prev), torch.from_numpy(s0),
            TCtx(quant=True, compute_dtype=torch.float32, wkv_chunk=16),
            n_heads=h)
    finally:
        t_rk.wkv_chunked = real
    # whole chunks through the chunked form, the tail through the
    # recurrence, the state carried across
    assert calls == ([(s // 16) * 16] if s > 16 else [])
    assert _scaled_err(ty, jy) <= _OFF_GRID_TOL
    assert _scaled_err(ts, js) <= _OFF_GRID_TOL
    assert {k: int(v) for k, v in trep.as_metrics().items()} == \
        {k: int(v) for k, v in jrep.as_metrics().items()
         if k in trep.as_metrics()}


def test_engine_off_the_chunk_grid_matches_the_unpatched_jax_engine():
    from repro.layers.common import Ctx as JCtx
    from repro.models import rwkv as j_rwkv
    from repro_torch.layers.common import Ctx as TCtx
    from repro_torch.models import rwkv as t_rwkv

    def stream(fn):
        return fn(3, tenants={"default": 1.0}, rate_rps=1e6, seed=1,
                  mean_prompt=12, max_prompt=24, mean_output=4,
                  max_output=6)

    # the JAX engine as it serves: its prefill runs the recurrence alone
    j_eng = JEngine(J_CFG, [JTenant("default", j_default_plan())],
                    max_prompt=24, max_new_tokens=6,
                    compute_dtype=jnp.float32)
    j_tel = j_eng.run(stream(j_chat_stream))
    eng = ServingEngine(T_CFG, [TenantSpec("default", default_plan())],
                        max_prompt=24, compute_dtype=torch.float32,
                        device="cpu")
    np_params = jax.tree.map(np.asarray, j_eng.params)
    eng.params = from_jax(np_params, device="cpu")
    tel = eng.run(stream(chat_stream))

    counters, j_counters = (t.summary()["faults"]["counters"]
                            for t in (tel, j_tel))
    assert counters == {k: j_counters[k] for k in counters}
    assert counters["qgemm_errors"] == counters["embedding_bag_errors"] == 0
    assert tel.summary()["per_tenant"]["default"]["completed"] == 3

    # each request teacher-forced with the JAX engine's tokens through both
    # models at batch 1: the prefill logits agree within the tolerance, and
    # the port's engine picked the JAX engine's token wherever the JAX
    # logits' top-two margin exceeds it (up to the first such close call)
    jctx = JCtx(quant=True, compute_dtype=jnp.float32)
    jpre = jax.jit(lambda p, t: j_rwkv.rwkv_prefill(p, t, jctx, J_CFG))
    jdec = jax.jit(lambda p, c, t: j_rwkv.rwkv_decode(p, c, t, None, jctx,
                                                      J_CFG))
    tctx = TCtx(quant=True, compute_dtype=torch.float32,
                wkv_chunk=T_CFG.wkv_chunk)
    jp = jax.tree.map(jnp.asarray, np_params)
    got = {r.rid: r.tokens for r in tel.requests}
    compared = 0
    for r in j_tel.requests:
        req = next(q for q in stream(chat_stream) if q.rid == r.rid)
        prompt = eng._chat_tokens(req, 24).astype(np.int32)[None]
        jl, jc, _ = jpre(jp, jnp.asarray(prompt))
        tl, tc, _ = t_rwkv.rwkv_prefill(eng.params, torch.from_numpy(prompt),
                                        tctx, T_CFG)
        assert _scaled_err(tl, jl) <= _OFF_GRID_TOL
        for i, tok in enumerate(r.tokens):
            logits = np.asarray(jl, np.float32)[0, :J_CFG.vocab]
            top2 = np.sort(logits)[-2:]
            if top2[1] - top2[0] <= _OFF_GRID_TOL * np.abs(logits).max():
                break
            assert got[r.rid][i] == tok
            compared += 1
            nxt = np.asarray([tok], np.int32)
            jl, jc, _ = jdec(jp, jc, jnp.asarray(nxt))
    assert compared >= 6


def test_serve_cli_rwkv_smoke_on_cpu(tmp_path):
    out = tmp_path / "tel.json"
    # 0.01 requests/s of virtual time: no two requests overlap, so every
    # prefill and decode step serves one request.  At the default 100
    # requests/s the counts depend on the steps' wall time, in the JAX
    # CLI too (330 and 255 qgemm checks in two runs of its smoke serve),
    # because a slower step lets the next arrival share decode steps
    assert serve.main(["--arch", "rwkv6-1.6b", "--device", "cpu", "--smoke",
                       "--requests", "4", "--rate", "0.01",
                       "--json", str(out)]) == 0
    tel = json.loads(out.read_text())
    per = tel["summary"]["per_tenant"]["default"]
    assert per["completed"] == 4 and per["aborted"] == 0
    counters = tel["summary"]["faults"]["counters"]
    assert counters["qgemm_checks"] == 330
    assert counters["embedding_bag_checks"] == 22
    assert counters["qgemm_errors"] == counters["embedding_bag_errors"] == 0
