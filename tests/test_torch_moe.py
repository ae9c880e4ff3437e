"""The port's MoE (``repro_torch.layers.moe``) and the reduced
granite-moe-3b-a800m against the JAX package, on the same numpy inputs.

The JAX side runs op by op (``jax.disable_jit``, ROADMAP §C5).  Held bit
for bit: the routing's expert indices (given the same float32
probabilities, and end to end), the slot assignment and its drop counts,
every expert's int32 C and the report counters.  Held within a stated
tolerance, each as a share of the reference's largest magnitude:

* ``moe_ffn``'s y and aux loss: float32 1e-6 (measured <= 5.4e-7: the
  gather combine's float32 sum and the einsums run in other orders),
  bfloat16 2**-8 (measured 0); aux 1e-6;
* the one-hot against the gather dispatch (the one-hot combine rounds
  the gate values to bf16, the gather combine keeps them float32):
  2**-7 (a bf16 gate is within 2**-9 of its float32 value, relative);
* the reduced granite's logits: the LM tests' tolerances
  (``tests/test_torch_lm.py``).

On these inputs the seed gives no near-tie at the top-k boundary: no
token's k-th and (k+1)-th probability lie within one float32 ulp of each
other (``test_routing_is_bit_exact``, which also builds exact ties).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduce import small_arch  # noqa: E402
from repro.core.inject import victim_leaf_index as j_victim  # noqa: E402
from repro.layers import moe as jm  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.models import lm as j_lm  # noqa: E402
from repro.protect import default_plan as j_default_plan  # noqa: E402
from repro.protect.plan import ProtectionPlan as JPlan  # noqa: E402
from repro.serving import ServingEngine as JEngine  # noqa: E402
from repro.serving import TenantSpec as JTenant  # noqa: E402
from repro.serving import chat_stream as j_chat_stream  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.core.inject import leaf_paths, victim_leaf_index  # noqa
from repro_torch.launch import serve  # noqa: E402
from repro_torch.layers import moe as tm  # noqa: E402
from repro_torch.layers.common import Ctx as TCtx  # noqa: E402
from repro_torch.models import base as t_base  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.protect import ProtectionPlan, default_plan  # noqa: E402
from repro_torch.serving import (ServingEngine, TenantSpec,  # noqa: E402
                                 chat_stream)

ARCH = "granite-moe-3b-a800m"
J_CFG = small_arch(ARCH)
T_CFG = reduce_cfg(get_arch(ARCH))
_Y_TOL = {"float32": 1e-6, "bfloat16": 2.0**-8}
_DISPATCH_TOL = 2.0**-7
#: the LM tests' tolerances (tests/test_torch_lm.py): logits op by op,
#: and against the jitted JAX model (ROADMAP §C5)
_LM_TOL = {"float32": 1e-5, "bfloat16": 2.0**-8}
_SPLIT_TOL = 2.0**-5
_JIT_TOL = {"float32": 2.0**-5, "bfloat16": 2.0**-4}
_KV_PLAN = "*:policy=recompute,kv_cache:on"


def _np(tree):
    return jax.tree.map(np.asarray, values_of(tree))


def _scaled_err(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def _metrics(rep):
    return {k: int(v) for k, v in rep.as_metrics().items()}


def _same_metrics(tm_, jm_):
    assert set(tm_) <= set(jm_)
    assert all(jm_[k] == 0 for k in set(jm_) - set(tm_))
    assert tm_ == {k: jm_[k] for k in tm_}


def _ctxs(dtype, plan_text="*:policy=log", **kw):
    return (JCtx(quant=True, compute_dtype=getattr(jnp, dtype),
                 plan=j_default_plan().with_rules(
                     *JPlan.from_any(plan_text).rules), **kw),
            TCtx(quant=True, compute_dtype=getattr(torch, dtype),
                 plan=default_plan().with_rules(
                     *ProtectionPlan.from_any(plan_text).rules), **kw))


@pytest.fixture(scope="module")
def moe_weights():
    return {q: _np(jm.init_moe(jax.random.key(0), J_CFG.d_model, J_CFG.d_ff,
                               J_CFG.n_experts, quant=q))
            for q in (True, False)}


def _x(dtype, seed=1, b=2, s=16, positive=False):
    x = np.random.default_rng(seed).standard_normal(
        (b, s, J_CFG.d_model)).astype(np.float32)
    if positive:
        x = np.abs(x)
    xj = jnp.asarray(x).astype(getattr(jnp, dtype))
    return xj, torch.from_numpy(np.asarray(xj.astype(jnp.float32))).to(
        getattr(torch, dtype))


def _moe_both(w, dtype, capacity_factor=None, plan_text="*:policy=log",
              positive=False, **ctx_kw):
    jctx, tctx = _ctxs(dtype, plan_text, **ctx_kw)
    xj, xt = _x(dtype, positive=positive)
    kw = dict(n_experts=J_CFG.n_experts, top_k=J_CFG.top_k,
              capacity_factor=(J_CFG.capacity_factor if capacity_factor
                               is None else capacity_factor),
              group_size=J_CFG.moe_group)
    with jax.disable_jit():
        jy, jaux, jr = jm.moe_ffn(jax.tree.map(jnp.asarray, w), xj, jctx,
                                  **kw)
    ty, taux, tr = tm.moe_ffn(from_jax(w, device="cpu"), xt, tctx, **kw)
    return (np.asarray(jy, np.float32), float(jaux), _metrics(jr),
            ty.float().numpy(), float(taux), _metrics(tr))


def _routing(w, dtype, capacity_factor, positive=False):
    """Both packages' routing, slots and per-expert int32 C on the same
    x, through their own functions; the port also on JAX's own float32
    probabilities."""
    xj, xt = _x(dtype, positive=positive)
    g = J_CFG.moe_group
    tokens = xj.shape[0] * xj.shape[1]
    cap = min(max(int(g * J_CFG.top_k * capacity_factor / J_CFG.n_experts),
                  4), g)
    rw = w["router"]["w"].astype(np.float32)
    jctx, tctx = _ctxs(dtype)
    with jax.disable_jit():
        jxg = xj.reshape(tokens // g, g, -1)
        jprobs, jvals, jidx = jm._route(jxg, jnp.asarray(rw), J_CFG.top_k)
        jslot = jm._slot_assignment(jidx, J_CFG.n_experts, cap)
        je_in, _ = jm._dispatch_gather(jxg, jidx, J_CFG.n_experts, cap)
        jc = jax.vmap(lambda pk, h: jm.pops.QGEMM.unprotected(
            pk, jm.kops.quantize_rows(h)[0]))(
            jnp.asarray(w["gate"]["w_packed"]), je_in)
    txg = xt.reshape(tokens // g, g, -1)
    tprobs, tvals, tidx = tm._route(txg, torch.from_numpy(rw), J_CFG.top_k)
    tslot = tm.slot_assignment(tidx, J_CFG.n_experts, cap)
    te_in = tm._dispatch_gather(txg, tslot, J_CFG.n_experts, cap)
    tp = from_jax(w, device="cpu")
    tc, _, _, rep = tm.expert_qgemm(tp["gate"], te_in, tctx)
    return dict(cap=cap, jprobs=np.asarray(jprobs), jidx=np.asarray(jidx),
                tidx=tidx.numpy(), jslot=np.asarray(jslot),
                tslot=tslot.numpy(), je_in=np.asarray(je_in, np.float32),
                te_in=te_in.float().numpy(), jc=np.asarray(jc),
                tc=tc.numpy(), rep=_metrics(rep))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routing_slots_and_expert_c_are_bit_exact(moe_weights, dtype,
                                                  capacity_factor):
    r = _routing(moe_weights[True], dtype, capacity_factor)
    np.testing.assert_array_equal(r["tidx"], r["jidx"])
    # given JAX's own probabilities, the port's top-k is JAX's
    _, own = tm.topk_stable(torch.from_numpy(r["jprobs"]), J_CFG.top_k)
    np.testing.assert_array_equal(own.numpy(), r["jidx"])
    np.testing.assert_array_equal(r["tslot"], r["jslot"])
    ec = J_CFG.n_experts * r["cap"]
    drops = int((r["tslot"] == ec).sum())
    assert drops == int((r["jslot"] == ec).sum())
    # at the reduced config's capacity 10 of a group's 32 choices one
    # expert overflows here; at a capacity factor of 0.5 (capacity 4, 16
    # slots) at least half of each group's choices drop
    assert drops >= (32 if capacity_factor < 1 else 1)
    np.testing.assert_array_equal(r["te_in"], r["je_in"])
    np.testing.assert_array_equal(r["tc"], r["jc"])
    assert r["rep"]["abft/qgemm_checks"] == J_CFG.n_experts
    assert r["rep"]["abft/qgemm_errors"] == 0


def test_routing_is_bit_exact(moe_weights):
    """Ties go to the lower index, as ``jax.lax.top_k`` breaks them, and
    the seed's inputs hold no near-tie at the top-k boundary."""
    probs = np.array([[[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4],
                       [0.3, 0.2, 0.3, 0.2]]], np.float32)
    jv, ji = jax.lax.top_k(jnp.asarray(probs), 2)
    tv, ti = tm.topk_stable(torch.from_numpy(probs), 2)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    near = 0
    for dtype in ("float32", "bfloat16"):
        p = np.sort(_routing(moe_weights[True], dtype, 1.25)["jprobs"], -1)
        kth, nxt = p[..., -J_CFG.top_k], p[..., -J_CFG.top_k - 1]
        near += int(np.sum(kth - nxt <= np.spacing(kth)))
    assert near == 0


@pytest.mark.parametrize("seq", [False, True])
@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [True, False])
def test_moe_ffn_matches_jax(moe_weights, quant, dtype, gather, seq):
    jy, jaux, jr, ty, taux, tr = _moe_both(
        moe_weights[quant], dtype, moe_gather=gather, moe_seq_groups=seq)
    assert ty.shape == jy.shape == (2, 16, J_CFG.d_model)
    assert _scaled_err(ty, jy) <= _Y_TOL[dtype]
    assert abs(taux - jaux) <= 1e-6 * abs(jaux)
    _same_metrics(tr, jr)
    # 3 projections x 4 experts, once a group when the groups are run one
    # at a time
    assert tr["abft/qgemm_checks"] == (12 * (2 if seq else 1)
                                       if quant else 0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dispatches_agree_and_dropped_tokens_match_jax(moe_weights, dtype):
    w = moe_weights[True]
    outs = {}
    for gather in (False, True):
        jy, jaux, jr, ty, taux, tr = _moe_both(w, dtype, capacity_factor=0.5,
                                               moe_gather=gather)
        assert _scaled_err(ty, jy) <= _Y_TOL[dtype]
        _same_metrics(tr, jr)
        outs[gather] = ty
    assert _scaled_err(outs[False], outs[True]) <= _DISPATCH_TOL


@pytest.mark.parametrize("gather", [False, True])
def test_flip_in_an_expert_no_token_chose_is_flagged(moe_weights, gather):
    """Expert 3 gets no token (positive inputs, its router column
    negative, the others positive), yet a flip in its B' is flagged: its
    empty capacity rows quantize to -128, which the mod-127 check sees,
    as in JAX."""
    w = jax.tree.map(np.copy, moe_weights[True])
    rw = np.abs(w["router"]["w"])
    rw[:, 3] *= -1
    w["router"]["w"] = rw
    r = _routing(w, "bfloat16", 1.25, positive=True)
    assert not np.any(r["tidx"] == 3)
    w["gate"]["w_packed"][3, 5, 17] ^= np.int8(0x04)
    jy, _, jr, ty, _, tr = _moe_both(w, "bfloat16", moe_gather=gather,
                                     positive=True)
    _same_metrics(tr, jr)
    assert tr["abft/qgemm_errors"] > 0
    assert _scaled_err(ty, jy) <= _Y_TOL["bfloat16"]
    # recompute re-runs and keeps counting it: one retry, for one expert
    jy, _, jr, ty, _, tr = _moe_both(w, "bfloat16", plan_text="*:policy="
                                     "recompute", moe_gather=gather,
                                     positive=True)
    _same_metrics(tr, jr)
    assert tr["abft/retries"] == 1 and tr["abft/qgemm_checks"] == 12


# ------------------------------ the model -----------------------------------

@pytest.fixture(scope="module")
def weights():
    return _np(jax.jit(lambda k: j_lm.init_lm(k, J_CFG, quant=True))(
        jax.random.key(0)))


def _run_both(np_params, dtype, plan_text, steps=3, jit=False):
    jctx, tctx = _ctxs(dtype, plan_text)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = from_jax(np_params, device="cpu")
    tokens = np.random.default_rng(11).integers(
        0, J_CFG.vocab, (2, 16)).astype(np.int32)
    pos = np.full((2,), tokens.shape[1], np.int32)

    def jpre(p, t):
        return j_lm.lm_prefill(p, t, jctx, J_CFG, cache_len=24)

    def jdec(p, c, t, q):
        return j_lm.lm_decode(p, c, t, q, jctx, J_CFG)

    if jit:
        jpre, jdec = jax.jit(jpre), jax.jit(jdec)
    with jax.disable_jit(not jit):
        jl, jc, jr = jpre(jp, jnp.asarray(tokens))
    tl, tc, tr = t_lm.lm_prefill(tp, torch.from_numpy(tokens), tctx, T_CFG,
                                 cache_len=24)
    out = [(np.asarray(jl, np.float32), tl.float().numpy(), _metrics(jr),
            _metrics(tr))]
    for _ in range(steps):
        nxt = np.argmax(out[-1][0][:, :J_CFG.vocab], -1).astype(np.int32)
        with jax.disable_jit(not jit):
            jl, jc, jr = jdec(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc, tr = t_lm.lm_decode(tp, tc, torch.from_numpy(nxt),
                                    torch.from_numpy(pos), tctx, T_CFG)
        pos = pos + 1
        out.append((np.asarray(jl, np.float32), tl.float().numpy(),
                    _metrics(jr), _metrics(tr)))
    return out


def test_granite_tree_and_victims_are_the_jax_ones(weights):
    assert T_CFG == dataclasses.replace(T_CFG, **{
        f.name: getattr(J_CFG, f.name) for f in dataclasses.fields(J_CFG)
        if f.name != "source"})
    p = from_jax(weights, device="cpu")
    L, d, e, f = T_CFG.n_layers, T_CFG.d_model, T_CFG.n_experts, T_CFG.d_ff
    moe = p["layers"]["moe"]
    assert moe["router"]["w"].shape == (L, d, e)
    assert moe["gate"]["w_packed"].shape == (L, e, d, f + 128)
    assert moe["down"]["w_packed"].shape == (L, e, f, d + 128)
    assert moe["up"]["alpha"].shape == moe["up"]["colsum"].shape == (L, e, f)
    mine = t_base.build_model(T_CFG).init(0, quant=True, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    want = [(jax.tree_util.keystr(k), v.shape, v.dtype.name)
            for k, v in flat(weights)[0]]
    got = [(jax.tree_util.keystr(k), tuple(v.shape),
            str(v.dtype).removeprefix("torch."))
           for k, v in flat(mine)[0]]
    assert got == want
    # the converted leaves are JAX's, in JAX's (sorted-key) order
    jleaves = [(jax.tree_util.keystr(k).replace("']['", ".")
                .strip("[']"), v) for k, v in flat(weights)[0]]
    assert len(leaf_paths(p)) == len(jleaves)
    for (tpath, tleaf), (jpath, jleaf) in zip(leaf_paths(p), jleaves):
        assert tpath == jpath and tleaf.dtype != torch.bfloat16
        np.testing.assert_array_equal(tleaf.numpy(), jleaf)
    for pat in (None, "moe.gate", "moe.down", "moe.router", "attn.wq",
                "embed.table"):
        assert victim_leaf_index(mine, pat) == j_victim(weights, pat)


@pytest.mark.parametrize("dtype,plan_text", [
    ("float32", "*:policy=log"), ("bfloat16", "*:policy=log"),
    ("bfloat16", _KV_PLAN)])
def test_granite_prefill_and_decode_match_jax(weights, dtype, plan_text):
    out = _run_both(weights, dtype, plan_text)
    tol = _SPLIT_TOL if dtype == "float32" else _LM_TOL[dtype]
    for i, (jl, tl, jm_, tm_) in enumerate(out):
        assert tl.shape == jl.shape == (2, T_CFG.vocab_padded)
        assert np.all(np.isfinite(tl))
        assert _scaled_err(tl, jl) <= tol
        _same_metrics(tm_, jm_)
        # per layer: 4 attention projections and 3 x 4 experts; the head
        assert tm_["abft/qgemm_checks"] == 2 * (4 + 3 * 4) + 1
        assert tm_["abft/qgemm_errors"] == 0


def test_granite_matches_the_jitted_jax_model(weights):
    out = _run_both(weights, "bfloat16", _KV_PLAN, jit=True)
    for jl, tl, jm_, tm_ in out:
        assert _scaled_err(tl, jl) <= _JIT_TOL["bfloat16"]
        _same_metrics(tm_, jm_)


# ------------------------------ serving -------------------------------------

def _stream(fn):
    # at 1e6 requests/s every arrival lands inside the first engine step
    return fn(5, tenants={"a": 1.0, "b": 1.0}, rate_rps=1e6, seed=3,
              mean_prompt=20, max_prompt=32, mean_output=3, max_output=4)


@pytest.mark.parametrize("paged", [False, True])
def test_granite_engine_matches_the_jax_engine(paged):
    """The JAX engine runs op by op: jitted, its quantizers multiply by
    the reciprocal of 255 (ROADMAP §C5), and on this stream that moves
    two first tokens of the reduced granite, whose bf16 top two logits
    tie in the jitted run; op by op its tokens are the port's."""
    from repro import paging as jp
    from repro_torch import paging as tp
    plans = ("*:policy=log", _KV_PLAN) if not paged else \
        ("*:policy=log,kv_cache_paged:on",
         "*:policy=recompute,kv_cache_paged:on")
    jt = [JTenant(n, j_default_plan().with_rules(
        *JPlan.from_any(p).rules)) for n, p in zip("ab", plans)]
    tt = [TenantSpec(n, default_plan().with_rules(
        *ProtectionPlan.from_any(p).rules)) for n, p in zip("ab", plans)]
    # prompt buckets are whole MoE groups (16 tokens): JAX asserts it
    kw = dict(n_slots=2, max_prompt=32, max_new_tokens=4)
    je = JEngine(J_CFG, jt, paging=jp.PagingConfig(page_size=16,
                                                   n_pages=12)
                 if paged else None, **kw)
    te = ServingEngine(T_CFG, tt, device="cpu", paging=tp.PagingConfig(
        page_size=16, n_pages=12) if paged else None, **kw)
    te.params = from_jax(jax.tree.map(np.asarray, je.params), device="cpu")
    with jax.disable_jit():
        jtel = je.run(_stream(j_chat_stream))
    ttel = te.run(_stream(chat_stream))
    assert {r.rid: (r.tokens, r.aborted) for r in ttel.requests} == \
        {r.rid: (r.tokens, r.aborted) for r in jtel.requests}
    assert [(e.step, e.kind, e.lane, e.slot_rids) for e in ttel.steps] == \
        [(e.step, e.kind, e.lane, e.slot_rids) for e in jtel.steps]
    counters = ttel.summary()["faults"]["counters"]
    j_counters = jtel.summary()["faults"]["counters"]
    assert counters == {k: j_counters[k] for k in counters}
    assert counters["qgemm_checks"] == 33 * len(ttel.steps)
    assert len(ttel.requests) == 5 and len({e.lane for e in ttel.steps}) == 2
    assert sum(v for k, v in counters.items()
               if not k.endswith("_checks")) == 0


def test_serve_cli_serves_granite_on_cpu(tmp_path):
    import json
    out = tmp_path / "tel.json"
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--requests", "4", "--json", str(out)]) == 0
    tel = json.loads(out.read_text())
    s = tel["summary"]
    assert s["per_tenant"]["default"]["completed"] == 4
    c = s["faults"]["counters"]
    assert c["qgemm_checks"] > 0 and c["qgemm_checks"] % 33 == 0
    assert c["qgemm_errors"] == c["embedding_bag_errors"] == 0
    assert serve.main(["--arch", ARCH, "--device", "cpu", "--smoke",
                       "--requests", "2", "--inject-step", "1",
                       "--inject-victim", "moe.gate"]) == 0
