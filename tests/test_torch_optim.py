"""The port's AdamW, clipping and schedules (``repro_torch.optim``)
against the JAX package's (``repro.optim``) run op by op, on the CPU.

* AdamW is bit-exact: the same formula op for op, divisions by tensors,
  and the correctly rounded square root (PyTorch's vectorized CPU sqrt
  is not: the port takes it in float64 there, ``optim.adamw.ieee_sqrt``).
  XLA on the CPU flushes float32 subnormals to zero: ``0.95 ** 1703`` is
  0 there and 1.16e-38 here.  A bias correction of ``1 - tiny`` is 1
  either way, so no update moves; the inputs here stay clear of the
  subnormal range.
* The warmup-cosine schedule is bit-exact with JAX's once both take the
  same cosine: XLA's float32 ``cos`` and PyTorch's differ in the last
  bits (about 5% of arguments), so unpatched the cosine phase differs by
  a few ulps at some steps.
* ``clip_by_global_norm`` scales bit-exactly given the same norm; the
  norm's sums of squares are reduced in another order than XLA's, a few
  ulps apart.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as jopt  # noqa: E402
from repro.optim import schedule as jsched  # noqa: E402
from repro_torch import optim as topt  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import schedule as tsched  # noqa: E402


def _tree(rng, dtype=np.float32):
    return {"w": rng.standard_normal((48, 32)).astype(dtype),
            "b": rng.standard_normal((32,)).astype(dtype),
            "frozen": rng.integers(-127, 128, (16, 8)).astype(np.int8)}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


def _eq(jtree, ttree):
    for k in ttree:
        a = np.asarray(jtree[k])
        b = ttree[k].numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_adamw_init_moments_and_frozen_leaves():
    rng = np.random.default_rng(0)
    p = _tree(rng)
    js, ts = jopt.adamw_init(_j(p)), topt.adamw_init(_t(p))
    for k in p:
        assert tuple(ts["m"][k].shape) == np.asarray(js["m"][k]).shape
        assert ts["v"][k].dtype == torch.float32
    assert ts["m"]["frozen"].shape == (0,)
    assert ts["count"].dtype == torch.int32 and int(ts["count"]) == 0
    assert topt.is_trainable(torch.zeros(1, dtype=torch.bfloat16))
    assert not topt.is_trainable(torch.zeros(1, dtype=torch.int8))


@pytest.mark.parametrize("lr_kind", ["tensor", "python"])
def test_adamw_update_bit_exact_over_steps(lr_kind):
    """30 updates with gradients over eight decades, a tensor or Python
    learning rate: parameters, both moments and the count equal JAX's op
    by op, and the frozen int8 leaf is passed through."""
    rng = np.random.default_rng(1)
    p = _tree(rng)
    jp, tp = _j(p), _t(p)
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for it in range(30):
        g = {k: (rng.standard_normal(v.shape)
                 * 10.0 ** rng.integers(-6, 2)).astype(np.float32)
             for k, v in p.items() if k != "frozen"}
        g["frozen"] = np.zeros((16, 8), np.float32)
        lr = np.float32(10.0 ** -rng.uniform(2, 4))
        with jax.disable_jit():
            jp, js = jopt.adamw_update(
                _j(g), js, jp, jnp.asarray(lr) if lr_kind == "tensor"
                else float(lr))
        tp, ts = topt.adamw_update(
            _t(g), ts, tp, torch.tensor(lr) if lr_kind == "tensor"
            else float(lr))
        _eq(jp, tp)
        _eq(js["m"], ts["m"])
        _eq(js["v"], ts["v"])
        assert int(js["count"]) == int(ts["count"]) == it + 1
    np.testing.assert_array_equal(tp["frozen"].numpy(), p["frozen"])


def test_adamw_bf16_params_bit_exact():
    rng = np.random.default_rng(2)
    p32 = {k: v for k, v in _tree(rng).items() if k != "frozen"}
    jp = {k: jnp.asarray(v, jnp.bfloat16) for k, v in p32.items()}
    tp = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in p32.items()}
    js, ts = jopt.adamw_init(jp), topt.adamw_init(tp)
    for _ in range(5):
        g = {k: rng.standard_normal(v.shape).astype(np.float32)
             for k, v in p32.items()}
        with jax.disable_jit():
            jp, js = jopt.adamw_update(
                {k: jnp.asarray(v, jnp.bfloat16) for k, v in g.items()},
                js, jp, jnp.asarray(np.float32(1e-2)))
        tp, ts = topt.adamw_update(
            {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in g.items()},
            ts, tp, torch.tensor(np.float32(1e-2)))
        for k in p32:
            assert tp[k].dtype == torch.bfloat16
            np.testing.assert_array_equal(
                np.asarray(jp[k]).astype(np.float32),
                tp[k].to(torch.float32).numpy())
        _eq(js["m"], ts["m"])
        _eq(js["v"], ts["v"])


def test_ieee_sqrt_is_correctly_rounded():
    rng = np.random.default_rng(3)
    x = np.concatenate([np.abs(rng.standard_normal(200_000)),
                        10.0 ** rng.uniform(-30, 30, 200_000)]
                       ).astype(np.float32)
    np.testing.assert_array_equal(
        tadamw.ieee_sqrt(torch.from_numpy(x)).numpy(), np.sqrt(x))
    with jax.disable_jit():
        np.testing.assert_array_equal(np.asarray(jnp.sqrt(jnp.asarray(x))),
                                      np.sqrt(x))


class _JnpWith:
    """``jax.numpy`` with some functions replaced (one module's view)."""

    def __init__(self, **over):
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(jnp, name)


def _torch_cos(x):
    return jnp.asarray(torch.cos(torch.from_numpy(np.array(x))).numpy())


SCHEDULES = [(3e-4, 100, 300, 0.0), (1e-2, 5, 30, 1e-4), (1e-3, 0, 50, 0.0)]


@pytest.mark.parametrize("peak,warmup,total,floor", SCHEDULES)
def test_warmup_cosine_bit_exact_given_the_same_cosine(monkeypatch, peak,
                                                       warmup, total,
                                                       floor):
    monkeypatch.setattr(jsched, "jnp", _JnpWith(cos=_torch_cos))
    for s in range(0, total + 10):
        with jax.disable_jit():
            a = np.asarray(jsched.warmup_cosine(
                jnp.asarray(np.int32(s)), peak=peak, warmup=warmup,
                total=total, floor=floor))
        b = tsched.warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                 peak=peak, warmup=warmup, total=total,
                                 floor=floor)
        assert b.dtype == torch.float32
        assert a.tobytes() == b.numpy().tobytes(), s


@pytest.mark.parametrize("peak,warmup,total,floor", SCHEDULES)
def test_warmup_cosine_within_the_cosines_ulps(peak, warmup, total, floor):
    """Unpatched, only the cosine phase differs, by XLA's and PyTorch's
    float32 cosines: at most 4 ulps of the peak (measured: 9 of 410
    steps of the first schedule differ, the largest by 2.9e-11)."""
    ulp = np.spacing(np.float32(peak))
    for s in range(0, total + 10):
        with jax.disable_jit():
            a = float(jsched.warmup_cosine(
                jnp.asarray(np.int32(s)), peak=peak, warmup=warmup,
                total=total, floor=floor))
        b = float(tsched.warmup_cosine(torch.tensor(s, dtype=torch.int32),
                                       peak=peak, warmup=warmup,
                                       total=total, floor=floor))
        if s < warmup:
            assert a == b, s
        assert abs(a - b) <= 4 * ulp, (s, a, b)


def test_constant_lr():
    for s in (0, 7):
        with jax.disable_jit():
            a = np.asarray(jsched.constant_lr(jnp.asarray(np.int32(s)),
                                              peak=3e-4))
        b = tsched.constant_lr(torch.tensor(s, dtype=torch.int32),
                               peak=3e-4)
        assert a.dtype == b.numpy().dtype == np.float32
        assert a.tobytes() == b.numpy().tobytes()


@pytest.mark.parametrize("max_norm", [1.0, 0.5, 1e3])
def test_clip_by_global_norm(max_norm):
    """Scaling is bit-exact given the same norm (dyadic grads: every sum
    of squares is exact in any order); on random grads the norm is a few
    ulps from XLA's (another summation order) and the clipped grads
    within as many."""
    rng = np.random.default_rng(4)
    dyadic = {"w": (rng.integers(-8, 9, (48, 32)) / 4).astype(np.float32),
              "b": (rng.integers(-8, 9, (32,)) / 8).astype(np.float32),
              "frozen": rng.integers(-127, 128, (4,)).astype(np.int8)}
    with jax.disable_jit():
        jc, jn = jopt.clip_by_global_norm(_j(dyadic), max_norm)
    tc, tn = topt.clip_by_global_norm(_t(dyadic), max_norm)
    assert np.asarray(jn).tobytes() == tn.numpy().tobytes()
    _eq(jc, tc)

    rand = {k: v for k, v in _tree(rng).items()}
    with jax.disable_jit():
        jc, jn = jopt.clip_by_global_norm(_j(rand), max_norm)
        jg = jopt.global_norm(_j(rand))
    tc, tn = topt.clip_by_global_norm(_t(rand), max_norm)
    assert float(topt.global_norm(_t(rand))) == float(tn)
    assert float(jg) == float(jn)
    assert abs(float(jn) - float(tn)) <= 8 * np.spacing(np.float32(jn))
    for k in ("w", "b"):
        np.testing.assert_allclose(tc[k].numpy(), np.asarray(jc[k]),
                                   rtol=1e-6, atol=0)
    _eq(jc, {"frozen": tc["frozen"]})
