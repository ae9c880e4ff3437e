"""The port's float linear, MLP, ``quantize_linear``, the ``float_gemm``
adapter and the float DLRM against the JAX package, with the weights
carried across by ``from_jax``.

Float results are held in float32 (the compute dtype of these tests):
the two products sum in different orders, so outputs agree within
``_F32`` of their scale (measured ~1e-7); reports (checks, errors) are
integers and equal.  ``quantize_linear``'s packed weight and column sums
are integers, held bit for bit; its scales are computed by the same
operations and equal.  A weight flip is decided alike on both sides: a
high exponent bit far past the bound, the lowest mantissa bit far below
it.
"""
import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.dlrm import EXTRAS as J_EXTRAS  # noqa: E402
from repro.layers import linear as J_lin  # noqa: E402
from repro.layers import mlp as J_mlp  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.models.dlrm import dlrm_forward as j_forward  # noqa: E402
from repro.models.dlrm import init_dlrm as j_init  # noqa: E402
from repro.protect import ProtectionPlan as JPlan  # noqa: E402
from repro.protect import default_plan as j_default_plan  # noqa: E402
from repro.protect import protect as j_protect  # noqa: E402
from repro.protect.ops import FLOAT_GEMM as J_FG  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.configs.dlrm import EXTRAS as T_EXTRAS  # noqa: E402
from repro_torch.layers import linear as T_lin  # noqa: E402
from repro_torch.layers import mlp as T_mlp  # noqa: E402
from repro_torch.layers.common import Ctx as TCtx  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.models.dlrm import dlrm_forward as t_forward  # noqa: E402
from repro_torch.models.dlrm import quantize_dlrm  # noqa: E402
from repro_torch.protect import ProtectionPlan as TPlan  # noqa: E402
from repro_torch.protect import default_plan as t_default_plan  # noqa: E402
from repro_torch.protect import protect as t_protect  # noqa: E402
from repro_torch.protect.ops import FLOAT_GEMM as T_FG  # noqa: E402

_F32 = 1e-5
_SMOKE = dict(table_rows=512, n_tables=4, emb_dim=32, bottom_mlp=(64, 32),
              top_mlp=(64, 32, 1))


def _np(tree):
    return jax.tree.map(np.asarray, values_of(tree))


def _ctxs(plan):
    jp = None if plan is None else JPlan.parse(plan)
    tp = None if plan is None else TPlan.parse(plan)
    return (JCtx(plan=jp, compute_dtype=jnp.float32),
            TCtx(plan=tp, compute_dtype=torch.float32))


def _metrics(rep):
    return {k: int(v) for k, v in rep.as_metrics().items()}


def _same(t_rep, j_rep):
    """The port's report equals the JAX report on the port's keys; the
    JAX package may carry more op kinds (a test process can register its
    own), all zero here."""
    tm, jm = _metrics(t_rep), _metrics(j_rep)
    assert tm == {k: jm[k] for k in tm}
    assert not any(jm[k] for k in set(jm) - set(tm))
    return tm


def _close(got, want, tol=_F32):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= tol * scale


def _flip(w: np.ndarray, idx, bit: int) -> np.ndarray:
    out = w.copy()
    out.view(np.uint32)[idx] ^= np.uint32(1 << bit)
    return out


@pytest.mark.parametrize("plan", [None, "float_gemm:on",
                                  "float_gemm:on:rel_bound=1e-6"])
@pytest.mark.parametrize("bias", [True, False])
def test_linear_equals_jax(rng, plan, bias):
    p = _np(J_lin.init_linear(jax.random.key(1), 48, 40, bias=bias))
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    jctx, tctx = _ctxs(plan)
    jy, jr = J_lin.apply_linear(jax.tree.map(jnp.asarray, p),
                                jnp.asarray(x), jctx, name="mlp.up")
    ty, tr = T_lin.apply_linear(from_jax(p, device="cpu"),
                                torch.from_numpy(x), tctx, name="mlp.up")
    _close(ty.numpy(), jy)
    tm = _same(tr, jr)
    assert tm["abft/float_gemm_checks"] == (plan is not None)
    assert tm["abft/float_gemm_errors"] == 0


@pytest.mark.parametrize("bit,flagged", [(30, True), (29, None), (0, False)])
def test_float_gemm_decides_a_weight_flip_as_jax(rng, bit, flagged):
    w = (rng.standard_normal((64, 24)) * 0.1).astype(np.float32)
    a = rng.standard_normal((6, 64)).astype(np.float32)
    cs = np.asarray(J_FG.encode(jnp.asarray(w))[1])
    t_cs = T_FG.encode(torch.from_numpy(w))[1]
    np.testing.assert_allclose(t_cs.numpy(), cs, rtol=1e-6, atol=1e-6)
    bad = _flip(w, (10, 7), bit)
    _, jc = J_FG((jnp.asarray(bad), jnp.asarray(cs)), jnp.asarray(a))
    _, tc = T_FG((torch.from_numpy(bad), t_cs), torch.from_numpy(a))
    np.testing.assert_array_equal(tc.err_mask.numpy(),
                                  np.asarray(jc.err_mask))
    assert int(tc.err_count) == int(jc.err_count)
    if flagged is not None:
        assert bool(tc.err_count) == flagged
    # row sums taken from the faulty weight at the call see nothing
    _, jn = J_FG(jnp.asarray(bad), jnp.asarray(a))
    _, tn = T_FG(torch.from_numpy(bad), torch.from_numpy(a))
    assert int(tn.err_count) == int(jn.err_count) == 0
    # through the layer: encode_linear keeps the clean row sums
    p = T_lin.encode_linear({"w": torch.from_numpy(w)})
    p["w"] = torch.from_numpy(bad)
    _, rep = T_lin.linear(p, torch.from_numpy(a),
                          TCtx(plan=TPlan.parse("float_gemm:on"),
                               compute_dtype=torch.float32), name="x")
    assert int(rep.errors["float_gemm"]) == int(jc.err_count)


@pytest.mark.parametrize("gated,quant", [(True, False), (False, False),
                                         (True, True)])
def test_mlp_equals_jax(rng, gated, quant):
    p = _np(J_mlp.init_mlp(jax.random.key(2), 32, 80, gated=gated,
                           quant=quant))
    x = rng.standard_normal((7, 32)).astype(np.float32)
    jctx, tctx = _ctxs("float_gemm:on")
    jy, jr = J_mlp.mlp(jax.tree.map(jnp.asarray, p), jnp.asarray(x), jctx)
    ty, tr = T_mlp.mlp(from_jax(p, device="cpu"), torch.from_numpy(x), tctx)
    _close(ty.numpy(), jy)
    kind = "qgemm" if quant else "float_gemm"
    assert _same(tr, jr)[f"abft/{kind}_checks"] == (3 if gated else 2)


def test_mlp_init_has_the_jax_layout():
    gen = torch.Generator().manual_seed(0)
    p = T_mlp.init_mlp(gen, 16, 40, device="cpu")
    j = _np(J_mlp.init_mlp(jax.random.key(0), 16, 40))
    assert {k: {n: tuple(v.shape) for n, v in d.items()}
            for k, d in p.items()} == \
        {k: {n: v.shape for n, v in d.items()} for k, d in j.items()}


def test_quantize_linear_equals_jax(rng):
    p = _np(J_lin.init_linear(jax.random.key(3), 96, 50))
    p["b"] = rng.standard_normal(50).astype(np.float32)
    jq = _np(J_lin.quantize_linear(jax.tree.map(jnp.asarray, p)))
    tq = T_lin.quantize_linear(from_jax(p, device="cpu"))
    assert set(tq) == set(jq)
    for k in ("w_packed", "colsum", "alpha", "b"):
        np.testing.assert_array_equal(tq[k].numpy(), jq[k])
    x = rng.standard_normal((4, 96)).astype(np.float32)
    jctx, tctx = _ctxs(None)
    jy, jr = J_lin.apply_linear(jax.tree.map(jnp.asarray, jq),
                                jnp.asarray(x), jctx)
    ty, tr = T_lin.apply_linear(tq, torch.from_numpy(x), tctx)
    _close(ty.numpy(), jy)
    _same(tr, jr)


def test_from_jax_moves_bfloat16_by_its_bits():
    p = _np(J_lin.init_linear(jax.random.key(4), 8, 12, dtype=jnp.bfloat16))
    t = from_jax(p, device="cpu")
    assert t["w"].dtype == torch.bfloat16
    np.testing.assert_array_equal(t["w"].view(torch.int16).numpy(),
                                  p["w"].view(np.int16))
    np.testing.assert_array_equal(t["w"].float().numpy(),
                                  p["w"].astype(np.float32))


def test_float_dlrm_and_its_int8_conversion_equal_jax(rng):
    j_ex = dataclasses.replace(J_EXTRAS, **_SMOKE)
    t_ex = dataclasses.replace(T_EXTRAS, **_SMOKE)
    p = _np(jax.jit(functools.partial(j_init, ex=j_ex, quant=False))(
        jax.random.key(0)))
    assert "w" in p["bottom"][0] and "w_packed" not in p["top"][0]
    dense = rng.standard_normal((10, j_ex.n_dense)).astype(np.float32)
    idx = rng.integers(0, j_ex.table_rows, (j_ex.n_tables, 10, 16))
    bags = np.where(rng.integers(0, 4, idx.shape) > 0, idx,
                    -1).astype(np.int32)

    def both(jp, tp, plan_j, plan_t, dtype):
        jf = j_protect(functools.partial(j_forward, ex=j_ex), plan_j,
                       compute_dtype=getattr(jnp, dtype))
        tf = t_protect(functools.partial(t_forward, ex=t_ex), plan_t,
                       compute_dtype=getattr(torch, dtype))
        jl, jr = jf(jax.tree.map(jnp.asarray, jp), jnp.asarray(dense),
                    jnp.asarray(bags))
        tl, tr = tf(tp, torch.from_numpy(dense), torch.from_numpy(bags))
        return (np.asarray(jl, np.float32), tl.float().numpy(),
                _same(tr, jr))

    plan = "float_gemm:on"
    jl, tl, tm = both(p, from_jax(p, device="cpu"), JPlan.parse(plan),
                      TPlan.parse(plan), "float32")
    _close(tl, jl)
    assert tm["abft/float_gemm_checks"] == 5
    assert tm["abft/float_gemm_errors"] == 0

    # float -> int8 by quantize_linear, as the JAX docstring describes
    jq = dict(p, bottom=[_np(J_lin.quantize_linear(
        jax.tree.map(jnp.asarray, lp))) for lp in p["bottom"]],
        top=[_np(J_lin.quantize_linear(jax.tree.map(jnp.asarray, lp)))
             for lp in p["top"]])
    tq = quantize_dlrm(from_jax(p, device="cpu"))
    for jl_, tl_ in zip(jq["bottom"] + jq["top"], tq["bottom"] + tq["top"]):
        np.testing.assert_array_equal(tl_["w_packed"].numpy(),
                                      jl_["w_packed"])
    jl, tl, tm = both(jq, tq, j_default_plan(), t_default_plan(),
                      "float32")
    _close(tl, jl)
    assert tm["abft/qgemm_checks"] == 5
    assert tm["abft/qgemm_errors"] == 0 and tm["abft/eb_errors"] == 0
