"""The port's checksum algebra, plans and protected-call runtime against
the JAX package on the same numpy inputs — bit-exact in every integer,
and the same FaultReport counters under every policy."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core import abft_embedding as jeb  # noqa: E402
from repro.core import abft_gemm as jg  # noqa: E402
from repro.core import policy as jpolicy  # noqa: E402
from repro.protect import plan as jplan  # noqa: E402
from repro.protect.runtime import protected_call as j_call  # noqa: E402
from repro_torch.core import abft_embedding as teb  # noqa: E402
from repro_torch.core import abft_gemm as tg  # noqa: E402
from repro_torch.core.policy import FaultAbort  # noqa: E402
from repro_torch.protect import plan as tplan  # noqa: E402
from repro_torch.protect.runtime import protected_call as t_call  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(t, j):
    np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def _gemm(rng, m=8, k=48, n=40, dtype="uint8", flip=None):
    lo, hi = (0, 256) if dtype == "uint8" else (-128, 128)
    a = rng.integers(lo, hi, size=(m, k)).astype(dtype)
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    packed = np.array(jg.pack_encoded_b(jnp.array(b)))
    if flip is not None:                  # payload flip, checksum stale
        packed[flip[0], flip[1]] ^= np.int8(flip[2])
    colsum = np.array(jg.encode_weight_colsum(jnp.array(b)))
    return a, b, packed, colsum


# ----------------------------- GEMM algebra ---------------------------------

@pytest.mark.parametrize("k,n", [(13, 512), (64, 1), (100, 77)])
def test_pack_and_checksums_bit_exact(rng, k, n):
    b = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    _eq(tg.pack_encoded_b(_t(b)), jg.pack_encoded_b(jnp.asarray(b)))
    _eq(tg.encode_weight_checksum(_t(b)),
        jg.encode_weight_checksum(jnp.asarray(b)))
    _eq(tg.encode_weight_colsum(_t(b)),
        jg.encode_weight_colsum(jnp.asarray(b)))


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
def test_verify_rows_and_schemes_bit_exact(rng, dtype):
    a, b, packed, _ = _gemm(rng, dtype=dtype, flip=(3, 9, 0x40))
    c, err_rows, cnt = tg.abft_qgemm_packed(_t(a), _t(packed))
    cj, err_j, cnt_j = jg.abft_qgemm_packed(jnp.asarray(a),
                                            jnp.asarray(packed))
    _eq(c, cj)
    _eq(err_rows, err_j)
    assert int(cnt) == int(cnt_j) > 0
    for t_out, j_out in ((tg.abft_qgemm_unfused(_t(a), _t(b)),
                          jg.abft_qgemm_unfused(jnp.asarray(a),
                                                jnp.asarray(b))),
                         (tg.abft_qgemm(_t(a), _t(b)),
                          jg.abft_qgemm(jnp.asarray(a), jnp.asarray(b)))):
        for x, y in zip(t_out, j_out):
            _eq(x, y)
    _eq(tg.encode_activation_checksum(_t(a)),
        jg.encode_activation_checksum(jnp.asarray(a)))


def test_correct_single_error_bit_exact(rng):
    a, b, packed, _ = _gemm(rng)
    c = tg.abft_qgemm_packed(_t(a), _t(packed)).c
    col = tg.column_check(_t(a), _t(b))
    for cell, upset in (((2, 5), -4321), ((0, 0), 7)):
        bad = c.clone()
        bad[cell] += upset
        err_rows = torch.zeros(c.shape[0], dtype=torch.bool)
        err_rows[cell[0]] = True
        fixed, applied = tg.correct_single_error(bad, err_rows, col)
        fj, aj = jg.correct_single_error(jnp.asarray(bad.numpy()),
                                         jnp.asarray(err_rows.numpy()),
                                         jnp.asarray(col.numpy()))
        _eq(fixed, fj)
        assert bool(applied) == bool(aj) is True
        _eq(fixed, c)


@pytest.mark.parametrize("flip", [(5, 7, 0x20), (0, 0, 0x01), (47, 39, -128)])
def test_correct_weight_flip_bit_exact(rng, flip):
    a, b, packed, colsum = _gemm(rng, flip=flip)
    c = tg.abft_qgemm_packed(_t(a), _t(packed)).c
    fixed, applied = tg.correct_weight_flip(c, _t(a), _t(packed),
                                            _t(colsum))
    fj, aj = jg.correct_weight_flip(jnp.asarray(c.numpy()), jnp.asarray(a),
                                    jnp.asarray(packed), jnp.asarray(colsum))
    _eq(fixed, fj)
    assert bool(applied) == bool(aj) is True
    clean = tg.int_matmul(_t(a), _t(b))
    _eq(fixed, clean)


def test_detect_prob_model_matches():
    for m in (1, 10, 100):
        assert tg.detect_prob_b_bitflip(m) == jg.detect_prob_b_bitflip(m)
        assert tg.detect_prob_b_random(m) == jg.detect_prob_b_random(m)
    assert tg.detect_prob_c_random() == jg.detect_prob_c_random()


# ------------------------------ EB algebra ----------------------------------

@pytest.mark.parametrize("rel_bound", [1e-5, 1e-3])
def test_verify_bags_flags_match(rng, rel_bound):
    rows, d, bags, pool = 200, 64, 12, 20
    t = rng.integers(-127, 128, size=(rows, d)).astype(np.int8)
    al = rng.uniform(5e-3, 2e-2, size=rows).astype(np.float32)
    be = rng.uniform(-0.1, 0.1, size=rows).astype(np.float32)
    idx = rng.integers(-1, rows, size=(bags, pool)).astype(np.int32)
    w = rng.uniform(0.5, 2.0, size=(bags, pool)).astype(np.float32)
    rs = np.array(jeb.table_rowsums(jnp.asarray(t)))
    _eq(teb.table_rowsums(_t(t)), rs)
    # corrupt rows read by bags 0 and 3 in a high and a low bit
    t[int(idx[0, 1]) if idx[0, 1] >= 0 else 0, 3] ^= np.int8(0x40)
    t[int(idx[3, 2]) if idx[3, 2] >= 0 else 0, 9] ^= np.int8(0x01)
    for weights in (None, w):
        out = teb.abft_embedding_bag(_t(t), _t(al), _t(be), _t(idx), _t(rs),
                                     None if weights is None
                                     else _t(weights), rel_bound)
        ref = jeb.abft_embedding_bag(jnp.asarray(t), jnp.asarray(al),
                                     jnp.asarray(be), jnp.asarray(idx),
                                     jnp.asarray(rs),
                                     None if weights is None
                                     else jnp.asarray(weights), rel_bound)
        _eq(out.err_bags, ref.err_bags)
        assert int(out.err_count) == int(ref.err_count) >= 1
        np.testing.assert_allclose(out.r.numpy(), np.asarray(ref.r),
                                   rtol=1e-5, atol=1e-5)


# ------------------------------- plans --------------------------------------

PLANS = [
    "*:policy=log",
    "*:policy=recompute:retries=2,embedding_bag:off",
    "qgemm/bottom.*:scheme=unfused,qgemm:policy=correct",
    "off,qgemm/top.1:on:policy=abort",
    "embedding_bag:rel_bound=1e-4:threshold=adaptive,kv_cache:on",
    "qgemm:scheme=pallas,embedding_bag:scheme=xla",
]
SITES = [("qgemm", "bottom.0"), ("qgemm", "top.1"), ("qgemm", "top.4"),
         ("embedding_bag", "tables"), ("kv_cache", "attn"),
         ("float_gemm", "mlp.up"), ("kv_cache_paged", "attn")]


@pytest.mark.parametrize("text", PLANS)
def test_plan_parse_and_resolve_equal(text):
    tp, jp = tplan.ProtectionPlan.parse(text), jplan.ProtectionPlan.parse(text)
    assert tp.to_dict() == jp.to_dict()
    assert tp.describe() == jp.describe()
    assert tp.escalated().to_dict() == jp.escalated().to_dict()
    for op, path in SITES:
        assert (tp.resolve(op, path).__dict__
                == jp.resolve(op, path).__dict__), (op, path)


# -------------------------- protected_call policies -------------------------

def _counters(rep, keys=None):
    m = rep.as_metrics()
    return {k: int(v) for k, v in m.items() if keys is None or k in keys}


def _same_report(t_rep, j_rep):
    tm = _counters(t_rep)
    jm = _counters(j_rep)
    # other test modules may register extra JAX op kinds in this process;
    # those keys stay zero here
    assert set(tm) <= set(jm)
    assert all(jm[k] == 0 for k in set(jm) - set(tm))
    assert tm == {k: jm[k] for k in tm}


QGEMM_CASES = [(p, s) for p in ("log", "recompute", "correct")
               for s in ("packed", "unfused")] + [("log", "pallas")]


@pytest.mark.parametrize("policy,scheme", QGEMM_CASES)
@pytest.mark.parametrize("flipped", [False, True])
def test_qgemm_policies_same_report(rng, policy, scheme, flipped):
    a, b, packed, colsum = _gemm(rng, flip=(5, 7, 0x20) if flipped else None)
    # the port forces its CUDA kernel for scheme pallas, which the CPU
    # cannot run: the plain scheme packed stands in on this side
    t_scheme = "packed" if scheme == "pallas" else scheme
    j_rule = jplan.ResolvedRule(policy=policy, scheme=scheme,
                                max_retries=2)
    t_rule = tplan.ResolvedRule(policy=policy, scheme=t_scheme,
                                max_retries=2)
    enc_j = (jnp.asarray(packed), jnp.asarray(colsum)) \
        if policy == "correct" else jnp.asarray(packed)
    enc_t = (_t(packed), _t(colsum)) if policy == "correct" else _t(packed)
    cj, rj = j_call("qgemm", enc_j, jnp.asarray(a), rule=j_rule)
    ct, rt = t_call("qgemm", enc_t, _t(a), rule=t_rule)
    _eq(ct, cj)
    _same_report(rt, rj)
    if flipped and policy == "correct":
        assert int(rt.corrections) == 1 and int(rt.total_errors()) == 0


@pytest.mark.parametrize("policy", ["log", "recompute", "correct"])
def test_embedding_bag_policies_same_report(rng, policy):
    rows, d = 128, 32
    t = rng.integers(-127, 128, size=(rows, d)).astype(np.int8)
    al = rng.uniform(5e-3, 2e-2, size=rows).astype(np.float32)
    be = rng.uniform(-0.1, 0.1, size=rows).astype(np.float32)
    idx = rng.integers(0, rows, size=(4, 8)).astype(np.int32)
    rs = np.array(jeb.table_rowsums(jnp.asarray(t)))
    t[int(idx[1, 0]), 4] ^= np.int8(-128)
    rule_j = jplan.ResolvedRule(policy=policy)
    rule_t = tplan.ResolvedRule(policy=policy)
    rj_out, rj = j_call("embedding_bag", tuple(jnp.asarray(x)
                                               for x in (t, al, be, rs)),
                        jnp.asarray(idx), rule=rule_j)
    rt_out, rt = t_call("embedding_bag", tuple(_t(x) for x in (t, al, be, rs)),
                        _t(idx), rule=rule_t)
    _same_report(rt, rj)
    assert int(rt.errors["embedding_bag"]) >= 1
    np.testing.assert_allclose(rt_out.numpy(), np.asarray(rj_out), rtol=1e-5,
                               atol=1e-5)


def test_stacked_tables_count_one_check_per_table(rng):
    # one stacked call reports what a JAX vmap over per-table calls sums
    tables, rows, d = 3, 64, 16
    t = rng.integers(-127, 128, size=(tables, rows, d)).astype(np.int8)
    al = rng.uniform(5e-3, 2e-2, size=(tables, rows)).astype(np.float32)
    be = rng.uniform(-0.1, 0.1, size=(tables, rows)).astype(np.float32)
    idx = rng.integers(0, rows, size=(tables, 5, 6)).astype(np.int32)
    rs = np.stack([np.array(jeb.table_rowsums(jnp.asarray(x))) for x in t])
    t[2, int(idx[2, 0, 0]), 1] ^= np.int8(-128)
    for policy in ("log", "recompute"):
        rj = jpolicy.merge_reports(*[
            j_call("embedding_bag", tuple(jnp.asarray(x[i])
                                          for x in (t, al, be, rs)),
                   jnp.asarray(idx[i]),
                   rule=jplan.ResolvedRule(policy=policy))[1]
            for i in range(tables)])
        _, rt = t_call("embedding_bag", tuple(_t(x) for x in (t, al, be, rs)),
                       _t(idx), rule=tplan.ResolvedRule(policy=policy))
        _same_report(rt, rj)
        assert int(rt.checks["embedding_bag"]) == tables


def test_abort_raises_fault_abort(rng):
    a, b, packed, _ = _gemm(rng, flip=(1, 2, 0x04))
    rule = tplan.ResolvedRule(policy="abort")
    with pytest.raises(FaultAbort):
        t_call("qgemm", _t(packed), _t(a), rule=rule)
    with pytest.raises(Exception) as ei:
        j_call("qgemm", jnp.asarray(packed), jnp.asarray(a),
               rule=jplan.ResolvedRule(policy="abort"))
    assert jpolicy.is_fault_abort(ei.value)
    # clean operands pass the same rule with the JAX counters
    a, b, packed, _ = _gemm(rng)
    _, rt = t_call("qgemm", _t(packed), _t(a), rule=rule)
    _, rj = j_call("qgemm", jnp.asarray(packed), jnp.asarray(a),
                   rule=jplan.ResolvedRule(policy="abort"))
    _same_report(rt, rj)


def test_disabled_rule_runs_baseline_with_empty_report(rng):
    a, b, packed, _ = _gemm(rng)
    c, rep = t_call("qgemm", _t(packed), _t(a),
                    rule=tplan.ResolvedRule(enabled=False))
    _eq(c, tg.int_matmul(_t(a), _t(b)))
    assert int(rep.total_checks()) == 0
