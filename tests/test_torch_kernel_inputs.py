"""K3 and K4 read the RWKV path's bf16 activations as they are.

On the card the kernels convert bf16 to f32 in registers, which is exact,
so nothing may change in the numbers: here the plain path on bf16 input
is held against the same call on the float32 cast and against the JAX
package on the same numpy input, and the dispatch is held to handing the
kernel wrapper bf16 uncast.  K4's launch plan (``wkv_plan``) is made on
the host and checked here too.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.layers import rwkv6 as j_rk  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.kernels import quantize_rows as k3  # noqa: E402
from repro_torch.kernels import wkv6_chunked as k4  # noqa: E402
from repro_torch.layers.rwkv6 import LOG_W_MIN  # noqa: E402


def _bf16(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)


# ------------------------------ K3 on bf16 ---------------------------------

@pytest.mark.parametrize("m,n", [(10, 479), (64, 7168)])
def test_quantize_rows_bf16_bit_exact(m, n):
    x = _bf16(np.random.default_rng(0).standard_normal((m, n)) * 3)
    got = ops.quantize_rows(x)
    cast = ops.quantize_rows(x.float())
    want = jref.quantize_rows_ref(jnp.asarray(x.float().numpy()))
    for g, c, w in zip(got, cast, want):
        assert torch.equal(g, c)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("dtype,handed", [("bfloat16", "bfloat16"),
                                          ("float32", "float32"),
                                          ("float16", "float32")])
def test_quantize_rows_dispatch_hands_bf16_uncast(monkeypatch, dtype,
                                                  handed):
    """The card path hands bf16 and f32 to the kernel as they are and
    casts any other type to f32 (on a CPU tensor, with the kernel
    wrapper replaced by a recorder)."""
    seen = []

    def fake(x):
        seen.append(x.dtype)
        return ops._ref.quantize_rows_ref(x)

    monkeypatch.setattr(ops, "_use_kernel", lambda use_kernel, x: True)
    monkeypatch.setattr(k3, "quantize_rows_cuda", fake)
    x = torch.randn((4, 32), generator=torch.Generator().manual_seed(0))
    ops.quantize_rows(x.to(getattr(torch, dtype)))
    assert seen == [getattr(torch, handed)]


# ------------------------------ K4 on bf16 ---------------------------------

def _wkv_inputs(seed, b, s, h, dh):
    rng = np.random.default_rng(seed)
    r, k, v = (_bf16(rng.standard_normal((b, s, h, dh))) for _ in range(3))
    rest = [torch.from_numpy(a.astype(np.float32)) for a in (
        rng.uniform(LOG_W_MIN, 0.0, (b, s, h, dh)),
        rng.standard_normal((h, dh)) * 0.5,
        rng.standard_normal((b, h, dh, dh)) * 0.1)]
    return [r, k, v], rest


@pytest.mark.parametrize("chunk", [8, 16])
def test_wkv_bf16_equals_f32_cast_and_jax(chunk):
    rkv, rest = _wkv_inputs(chunk, 2, 64, 3, 8)
    y, st = ops.wkv_chunked(*rkv, *rest, chunk=chunk)
    y32, st32 = ops.wkv_chunked(*(t.float() for t in rkv), *rest,
                                chunk=chunk)
    assert y.dtype == st.dtype == torch.float32
    assert torch.equal(y, y32) and torch.equal(st, st32)
    jy, js = j_rk.wkv_chunked(*(jnp.asarray(t.float().numpy())
                                for t in rkv + rest), chunk=chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=2e-4,
                               atol=2e-4)
    np.testing.assert_allclose(st.numpy(), np.asarray(js), rtol=2e-4,
                               atol=2e-4)


@pytest.mark.parametrize("dtype,dh,handed", [
    ("bfloat16", 8, "bfloat16"), ("float32", 8, "float32"),
    ("float16", 8, "float32"),
    ("bfloat16", 7, "float32")])        # odd bf16 rows: no 4-byte copies
def test_wkv_dispatch_hands_bf16_uncast(monkeypatch, dtype, dh, handed):
    seen = []

    def fake(rh, kh, vh, lwh, u, state, *, chunk):
        seen.append({t.dtype for t in (rh, kh, vh)})
        return ops._ref.wkv_chunked_ref(rh, kh, vh, lwh, u, state,
                                        chunk=chunk)

    monkeypatch.setattr(ops, "_use_kernel", lambda use_kernel, x: True)
    monkeypatch.setattr(k4, "wkv6_chunked_cuda", fake)
    rkv, rest = _wkv_inputs(0, 1, 16, 2, dh)
    ops.wkv_chunked(*(t.to(getattr(torch, dtype)) for t in rkv), *rest,
                    chunk=16)
    assert seen == [{getattr(torch, handed)}]


# ------------------------------ K4's plan ----------------------------------

@pytest.mark.parametrize("itemsize,smem", [(2, 17408), (4, 26624)])
def test_wkv_plan_at_the_prefill_shape(itemsize, smem):
    """B 1, H 32, dh 64, chunk 16: 4 value slices of 16 per head, 128
    blocks (one wave on 132 SMs), 16-byte copies, two staging slots."""
    plan = k4.wkv_plan(1, 32, 64, 16, seq=64, itemsize=itemsize)
    assert plan.blocks == 128 and plan.grid == (32, 4) and plan.dv == 16
    assert plan.vec == 16 and plan.smem_bytes == smem


@pytest.mark.parametrize("dh", [1, 2, 4, 8, 12, 16, 24, 32, 36, 40, 48, 63,
                                64])
def test_wkv_plan_dv_divides_dh(dh):
    plan = k4.wkv_plan(2, 3, dh, 16, seq=32)
    assert dh % plan.dv == 0 and plan.dv <= k4.MAX_DV
    assert plan.dv == max(d for d in (16, 8, 4, 2, 1) if dh % d == 0)
    assert plan.grid == (6, dh // plan.dv)
    # 16-byte copies only where every staged row is 16-byte aligned
    assert plan.vec == (16 if dh % 4 == 0 and plan.dv % 4 == 0 else 4)
    assert k4.wkv_plan(2, 3, dh, 16, aligned=False).vec == 4


@pytest.mark.parametrize("kw,match", [
    (dict(dh=65), "head width"), (dict(dh=0), "head width"),
    (dict(chunk=17), "envelope"), (dict(chunk=0), "envelope"),
    (dict(seq=40), "multiple of chunk"),
    (dict(dh=63, itemsize=2), "even head width")])
def test_wkv_plan_raises_outside_the_kernel(kw, match):
    args = dict(b=1, h=32, dh=64, chunk=16, seq=64, itemsize=4)
    args.update(kw)
    with pytest.raises(ValueError, match=match):
        k4.wkv_plan(args.pop("b"), args.pop("h"), args.pop("dh"),
                    args.pop("chunk"), **args)
