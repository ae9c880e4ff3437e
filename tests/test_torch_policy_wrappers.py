"""The port's detect->act policy wrappers (``core.policy``: ``with_log``,
``with_recompute``, ``with_correct``, ``with_abort``, ``POLICIES``,
``apply_policy``, ``gemm_report``, ``eb_report``) against the JAX
package's on the same ops.  Everything compared is an integer or a
boolean, so every comparison is exact."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

import repro.protect  # noqa: E402,F401  (registers every JAX op kind)
from repro.core import policy as J  # noqa: E402
from repro_torch.core import abft_gemm as t_ag  # noqa: E402
from repro_torch.core import policy as T  # noqa: E402


def _ints(rep):
    return {k: int(v) for k, v in rep.as_metrics().items()}


def _same(t_rep, j_rep):
    """Equal on the port's keys; any op kind a test process registered on
    the JAX side only is zero."""
    tm, jm = _ints(t_rep), _ints(j_rep)
    assert tm == {k: jm[k] for k in tm}
    assert not any(jm[k] for k in set(jm) - set(tm))


def test_the_registries_agree():
    assert sorted(T.POLICIES) == sorted(J.POLICIES)
    with pytest.raises(KeyError):
        T.apply_policy("ignore", lambda: None)
    assert T.apply_policy("log", lambda: (1, 0)) is not None


@pytest.mark.parametrize("err", [0, 3])
def test_log_and_recompute_equal_jax(err):
    calls = {"t": 0, "j": 0}
    x = np.arange(6, dtype=np.int32)

    def t_op():
        calls["t"] += 1
        return torch.from_numpy(x), torch.tensor(err, dtype=torch.int32)

    def j_op():
        calls["j"] += 1
        return jnp.asarray(x), jnp.asarray(err, jnp.int32)

    for name, kw in (("log", {}), ("recompute", {"max_retries": 2})):
        t_out, t_err, t_ret = T.apply_policy(name, t_op, **kw)()
        j_out, j_err, j_ret = J.apply_policy(name, j_op, **kw)()
        np.testing.assert_array_equal(t_out.numpy(), np.asarray(j_out))
        assert int(t_err) == int(j_err) == err
        assert int(t_ret) == int(j_ret)
    # a persistent error is retried max_retries times, a clean op never
    assert int(t_ret) == (2 if err else 0)


def _gemm_case(rng, fault):
    a = rng.integers(-128, 128, (6, 40)).astype(np.int8)
    b = rng.integers(-127, 128, (40, 24)).astype(np.int8)
    t_pack = t_ag.pack_encoded_b(torch.from_numpy(b))
    out = t_ag.abft_qgemm_packed(torch.from_numpy(a), t_pack)
    c = out.c.clone()
    for (i, j, delta) in fault:
        c[i, j] += delta
    n = b.shape[1]
    check = t_ag.int_matmul(torch.from_numpy(a), t_pack[:, n:n + 1])[:, 0]
    err_rows, err_count = t_ag.verify_rows(c, check)
    col = t_ag.column_check(torch.from_numpy(a), torch.from_numpy(b))
    return out.c, (c, err_rows, err_count, col)


@pytest.mark.parametrize("fault", [[], [(2, 5, 37)], [(1, 3, 9), (4, 8, 2)]])
def test_correct_equals_jax(rng, fault):
    clean, t_args = _gemm_case(rng, fault)
    j_args = tuple(jnp.asarray(x.numpy()) for x in t_args)
    t_c, t_res, t_app = T.with_correct(lambda: t_args)()
    j_c, j_res, j_app = J.with_correct(lambda: j_args)()
    np.testing.assert_array_equal(t_c.numpy(), np.asarray(j_c))
    assert int(t_res) == int(j_res) and int(t_app) == int(j_app)
    if len(fault) == 1:                 # one cell: repaired, no residual
        assert torch.equal(t_c, clean) and int(t_app) == 1
        assert int(t_res) == 0
    elif fault:                         # two rows: left to recompute
        assert int(t_app) == 0 and int(t_res) == int(t_args[2]) > 0


def test_abort_raises_only_on_errors():
    ok = T.with_abort(lambda: (torch.ones(2), torch.tensor(0)))()
    assert int(ok[2]) == 0
    with pytest.raises(T.FaultAbort) as ei:
        T.with_abort(lambda: (torch.ones(2), torch.tensor([0, 2])))()
    assert T.is_fault_abort(ei.value)
    try:
        J.with_abort(lambda: (jnp.ones(2), jnp.asarray(2)))()
        raised = None
    except Exception as e:      # jax re-wraps the callback's exception
        raised = e
    assert raised is not None and J.is_fault_abort(raised)


@pytest.mark.parametrize("err,retries", [(0, 0), (2, 1)])
def test_legacy_reports_equal_jax(err, retries):
    _same(T.gemm_report(err, retries),
          J.gemm_report(jnp.asarray(err), jnp.asarray(retries)))
    _same(T.eb_report(err), J.eb_report(jnp.asarray(err)))
