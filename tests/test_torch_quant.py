"""The port's ``quant`` package and ``kernels.ref.int8_dot`` against the
JAX package's on the same numpy inputs.

Integers (the 8-bit codes, int32 products) are held bit for bit.  The
scales are computed by the same float32 operations in the same order
(IEEE division by a tensor on both sides), so against eager JAX they are
equal; the bound stated is one float32 ulp of the scale, the most a
division folded into a multiply by the reciprocal moves it (as jit does
with a Python-scalar divisor, checked below).  ``qgemm_f32`` sums its four
terms in the same order; its product is exact in int32 on both sides, so
the bound is a few float32 ulps of the output's scale (``_ULPS``).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as j_ref  # noqa: E402
from repro.quant import qtensor as J  # noqa: E402
from repro_torch.kernels import ref as t_ref  # noqa: E402
from repro_torch.quant import qtensor as T  # noqa: E402

_EPS = float(np.finfo(np.float32).eps)
_ULPS = 8


def _ulp_close(got, want, ulps=1):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    scale = np.maximum(np.abs(want), np.finfo(np.float32).tiny)
    assert np.all(np.abs(got - want) <= ulps * _EPS * scale)


def _x(rng, shape=(12, 300), s=3.0):
    return (rng.standard_normal(shape) * s).astype(np.float32)


@pytest.mark.parametrize("unsigned", [True, False])
@pytest.mark.parametrize("fn", ["quantize_rows", "quantize_tensor",
                                "requantize"])
def test_affine_quantizers_equal_jax(rng, fn, unsigned):
    x = _x(rng)
    jq = getattr(J, fn)(jnp.asarray(x), unsigned=unsigned)
    tq = getattr(T, fn)(torch.from_numpy(x), unsigned=unsigned)
    assert tq.axis == jq.axis
    assert str(tq.values.dtype).split(".")[1] == str(jq.values.dtype)
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    _ulp_close(tq.alpha.numpy(), jq.alpha)
    _ulp_close(tq.beta.numpy(), jq.beta)
    _ulp_close(T.dequantize(tq).numpy(), J.dequantize(jq), ulps=2)


def test_channels_equal_jax_and_its_jit_within_an_ulp(rng):
    w = _x(rng, (300, 24), 0.05)
    jq = J.quantize_channels(jnp.asarray(w))
    tq = T.quantize_channels(torch.from_numpy(w))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    assert tq.values.dtype == torch.int8 and tq.axis == 1
    _ulp_close(tq.alpha.numpy(), jq.alpha)
    assert not tq.beta.any()
    # jit folds the division by 127 into a multiply: one ulp at most
    jj = jax.jit(J.quantize_channels)(jnp.asarray(w))
    _ulp_close(tq.alpha.numpy(), jj.alpha)


def test_rounding_is_half_to_even():
    # a row spanning 0..255 has alpha 1, beta 0: codes of exact halves
    x = np.array([[0.0, 0.5, 1.5, 2.5, 3.5, 255.0]], np.float32)
    tq = T.quantize_rows(torch.from_numpy(x))
    jq = J.quantize_rows(jnp.asarray(x))
    np.testing.assert_array_equal(tq.values.numpy(), np.asarray(jq.values))
    assert tq.values[0].tolist() == [0, 0, 2, 2, 4, 255]


def test_int_matmul_and_int8_dot_bit_exact(rng):
    a = rng.integers(-128, 128, (17, 301)).astype(np.int8)
    au = rng.integers(0, 256, (17, 301)).astype(np.uint8)
    b = rng.integers(-128, 128, (301, 40)).astype(np.int8)
    for lhs in (a, au):
        want = np.asarray(J.int_matmul(jnp.asarray(lhs), jnp.asarray(b)))
        got = T.int_matmul(torch.from_numpy(lhs), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    got = t_ref.int8_dot(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(j_ref.int8_dot(jnp.asarray(a),
                                               jnp.asarray(b))))


@pytest.mark.parametrize("a_axis", ["rows", "tensor"])
def test_qgemm_f32_equals_jax(rng, a_axis):
    x, w = _x(rng, (9, 200)), _x(rng, (200, 33), 0.05)
    qa = (J.quantize_rows if a_axis == "rows" else J.quantize_tensor)
    ta = (T.quantize_rows if a_axis == "rows" else T.quantize_tensor)
    jqa, jqb = qa(jnp.asarray(x), unsigned=True), \
        J.quantize_channels(jnp.asarray(w))
    tqa, tqb = ta(torch.from_numpy(x), unsigned=True), \
        T.quantize_channels(torch.from_numpy(w))
    want = np.asarray(J.qgemm_f32(jqa, jqb))
    got = T.qgemm_f32(tqa, tqb).numpy()
    scale = float(np.abs(want).max())
    assert np.abs(got - want).max() <= _ULPS * _EPS * scale
    # the reconstruction is the float product within quantization error
    assert np.abs(got - x @ w).max() <= 0.05 * float(np.abs(x @ w).max())
    # a caller-supplied int32 product is used as it is
    c = T.int_matmul(tqa.values, tqb.values)
    assert torch.equal(T.qgemm_f32(tqa, tqb, c_temp=c), T.qgemm_f32(tqa,
                                                                     tqb))
