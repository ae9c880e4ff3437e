"""The port's RWKV6 against the JAX package on the same numpy inputs.

WKV: the plain chunked form (``kernels/ref.wkv_chunked_ref``, what the
CPU runs in place of kernel K4) and the per-token recurrence against the
JAX recurrence, the JAX chunked form and the interpreted Pallas kernel,
within the JAX tests' 2e-4.  Layers and model: JAX ``init_*(...,
quant=True)`` -> ``values_of`` -> numpy -> ``from_jax`` -> both forwards
at the ``--smoke`` size under ``Ctx(quant=True, wkv_chunk=16)``: the
FaultReport metrics must be identical, clean and with injected flips.
"""
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduce import small_arch  # noqa: E402
from repro.kernels.wkv6_chunked import wkv_chunked_pallas  # noqa: E402
from repro.layers import rwkv6 as j_rk  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.models import rwkv as j_rwkv  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.kernels.wkv6_chunked import wkv6_chunked_cuda  # noqa: E402
from repro_torch.layers import rwkv6 as t_rk  # noqa: E402
from repro_torch.layers.common import Ctx as TCtx  # noqa: E402
from repro_torch.layers.norms import layernorm  # noqa: E402
from repro_torch.models import rwkv as t_rwkv  # noqa: E402
from repro_torch.models.base import build_model  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402

J_CFG = small_arch("rwkv6-1.6b")
T_CFG = reduce_cfg(get_arch("rwkv6-1.6b"))

# Both forwards share every integer when their float inputs agree: the
# same quantized activations feed the same int8 GEMMs.  In float32 they
# differ by summation order and by the libraries' exp/tanh, in the last
# bits (measured 1e-7 to 5e-7 of the logit scale on most rows).  A
# last-bit difference can still round one activation to the neighbouring
# int8 code, and that change travels through the recurrence: measured
# 0.9% of the logit scale on one of this test's two f32 prompts.  In
# bfloat16 such roundings are common (XLA also keeps excess precision
# across fused bf16 chains): measured 2.5% of the logit scale, 1.8% of
# the state scale.  The bounds leave room for that; a lost or doubled
# term moves the logits by more than their scale, and the integer checks
# below are exact.
_TOL = {"float32": 2.0**-5, "bfloat16": 2.0**-4}


def _wkv_inputs(seed, b, s, h, dh, *, heavy):
    rng = np.random.default_rng(seed)
    lo = j_rk.LOG_W_MIN if heavy else -1.0
    return tuple(x.astype(np.float32) for x in (
        rng.standard_normal((b, s, h, dh)),
        rng.standard_normal((b, s, h, dh)),
        rng.standard_normal((b, s, h, dh)),
        rng.uniform(lo, 0.0, (b, s, h, dh)),
        rng.standard_normal((h, dh)) * 0.5,
        rng.standard_normal((b, h, dh, dh)) * 0.1))


def _close(got, want, tol=2e-4):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("chunk", [8, 16])
@pytest.mark.parametrize("heavy", [False, True])
def test_wkv_port_matches_jax(chunk, heavy):
    args = _wkv_inputs(chunk + heavy, 2, 64, 3, 8, heavy=heavy)
    targs = [torch.from_numpy(a) for a in args]
    jargs = [jnp.asarray(a) for a in args]
    want = {
        "jax recurrent": j_rk.wkv_recurrent(*jargs),
        "jax chunked": j_rk.wkv_chunked(*jargs, chunk=chunk),
        "pallas interpret": wkv_chunked_pallas(*jargs, chunk=chunk,
                                               interpret=True),
    }
    got = {
        "plain chunked": ref.wkv_chunked_ref(*targs, chunk=chunk),
        "recurrent": t_rk.wkv_recurrent(*targs),
        "dispatch": ops.wkv_chunked(*targs, chunk=chunk),
    }
    for (y, s_new) in got.values():
        assert y.shape == (2, 64, 3, 8) and s_new.shape == (2, 3, 8, 8)
        for (jy, js) in want.values():
            _close(y.numpy(), jy)
            _close(s_new.numpy(), js)


def test_wkv_worst_case_decay_finite():
    """All-min decay for whole chunks: the intra-chunk factor reaches
    e^(C |LOG_W_MIN|) = e^80 and must stay finite."""
    b, s, h, dh = 1, 32, 1, 4
    ones = torch.ones((b, s, h, dh))
    lw = torch.full((b, s, h, dh), t_rk.LOG_W_MIN)
    u, s0 = torch.ones((h, dh)), torch.ones((b, h, dh, dh))
    y, st = t_rk.wkv_chunked(ones, ones, ones, lw, u, s0, chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    y_ref, s_ref = t_rk.wkv_recurrent(ones, ones, ones, lw, u, s0)
    np.testing.assert_allclose(y.numpy(), y_ref.numpy(), rtol=1e-4)
    jy, _ = j_rk.wkv_chunked(*(jnp.asarray(t.numpy()) for t in
                               (ones, ones, ones, lw, u, s0)), chunk=16)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), rtol=1e-4)


def test_wkv_envelope_and_kernel_limits_rejected():
    args = [torch.from_numpy(a)
            for a in _wkv_inputs(0, 1, 64, 1, 4, heavy=False)]
    with pytest.raises(ValueError, match="envelope"):
        t_rk.wkv_chunked(*args, chunk=32)
    # a CUDA kernel has no CPU mode, and nothing falls back to one
    with pytest.raises(ValueError, match="CUDA"):
        ops.wkv_chunked(*args, chunk=16, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        wkv6_chunked_cuda(*args, chunk=16)
    with pytest.raises(ValueError, match="multiple of chunk"):
        ref.wkv_chunked_ref(*(a[:, :40] if a.dim() == 4 else a
                              for a in args[:4]), *args[4:], chunk=16)


def test_layernorm_is_population_variance():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((4, 16)).astype(np.float32) * 3 + 1
    p = {"scale": rng.uniform(0.5, 2, 16).astype(np.float32),
         "bias": rng.standard_normal(16).astype(np.float32)}
    from repro.layers.norms import layernorm as j_layernorm
    want = j_layernorm({k: jnp.asarray(v) for k, v in p.items()},
                       jnp.asarray(x))
    got = layernorm(from_jax(p, device="cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def _np(tree):
    return jax.tree.map(np.asarray, values_of(tree))


def _metrics(rep):
    return {k: int(v) for k, v in rep.as_metrics().items()}


def _assert_same_metrics(tm, jm):
    # other test modules may register extra JAX op kinds in this process;
    # those keys stay zero
    assert set(tm) <= set(jm)
    assert all(jm[k] == 0 for k in set(jm) - set(tm))
    assert tm == {k: jm[k] for k in tm}


def _ctxs(dtype):
    return (JCtx(quant=True, wkv_chunk=16, compute_dtype=getattr(jnp, dtype)),
            TCtx(quant=True, wkv_chunk=16,
                 compute_dtype=getattr(torch, dtype)))


def _scaled_err(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_timemix_and_channelmix_match_jax(dtype):
    d, h = J_CFG.d_model, J_CFG.n_heads
    k1, k2 = jax.random.split(jax.random.key(4))
    tm = _np(j_rk.init_timemix(k1, d, h, quant=True))
    cm = _np(j_rk.init_channelmix(k2, d, J_CFG.d_ff, quant=True))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 32, d)).astype(np.float32)
    x_prev = rng.standard_normal((2, d)).astype(np.float32)
    s0 = (rng.standard_normal((2, h, d // h, d // h)) * 0.1).astype(
        np.float32)
    jctx, tctx = _ctxs(dtype)
    jdt, tdt = jctx.compute_dtype, tctx.compute_dtype
    jy, jxp, js, jrep = j_rk.timemix(
        jax.tree.map(jnp.asarray, tm), jnp.asarray(x, jdt),
        jnp.asarray(x_prev, jdt), jnp.asarray(s0), jctx, n_heads=h)
    ty, txp, ts, trep = t_rk.timemix(
        from_jax(tm, device="cpu"), torch.from_numpy(x).to(tdt),
        torch.from_numpy(x_prev).to(tdt), torch.from_numpy(s0), tctx,
        n_heads=h)
    assert _scaled_err(ty.float(), jy) <= _TOL[dtype]
    assert _scaled_err(ts, js) <= _TOL[dtype]
    np.testing.assert_array_equal(txp.float().numpy(),
                                  np.asarray(jxp, np.float32))
    _assert_same_metrics(_metrics(trep), _metrics(jrep))
    assert _metrics(trep)["abft/qgemm_checks"] == 5

    jy2, _, jrep2 = j_rk.channelmix(jax.tree.map(jnp.asarray, cm), jy,
                                    jnp.asarray(x_prev, jdt), jctx)
    ty2, _, trep2 = t_rk.channelmix(
        from_jax(cm, device="cpu"),
        torch.tensor(np.asarray(jy, np.float32)).to(tdt),
        torch.from_numpy(x_prev).to(tdt), tctx)
    assert _scaled_err(ty2.float(), jy2) <= _TOL[dtype]
    _assert_same_metrics(_metrics(trep2), _metrics(jrep2))


@pytest.fixture(scope="module")
def weights():
    return _np(jax.jit(lambda k: j_rwkv.init_rwkv(k, J_CFG, quant=True))(
        jax.random.key(0)))


def _prompt():
    return np.random.default_rng(11).integers(
        0, J_CFG.vocab, (2, 32)).astype(np.int32)


@functools.cache
def _jax_steps(dtype):
    """The JAX prefill and decode, jitted once per dtype for the module."""
    jctx, _ = _ctxs(dtype)
    return (jax.jit(lambda p, t: j_rwkv.rwkv_prefill(p, t, jctx, J_CFG)),
            jax.jit(lambda p, c, t: j_rwkv.rwkv_decode(p, c, t, None, jctx,
                                                       J_CFG)))


def _run_both(np_params, tokens, dtype, steps=3):
    """Prefill then ``steps`` greedy decodes through both packages.
    Returns per step (jax logits, port logits, jax metrics, port
    metrics) and the final (jax, port) states."""
    _, tctx = _ctxs(dtype)
    jpre, jdec = _jax_steps(dtype)
    jp = jax.tree.map(jnp.asarray, np_params)
    tp = from_jax(np_params, device="cpu")
    jl, jc, jrep = jpre(jp, jnp.asarray(tokens))
    tl, tc, trep = t_rwkv.rwkv_prefill(tp, torch.from_numpy(tokens), tctx,
                                       T_CFG)
    out = [(np.asarray(jl, np.float32), tl.float().numpy(), _metrics(jrep),
            _metrics(trep))]
    for _ in range(steps):
        # both packages are fed the JAX package's greedy token
        nxt = np.argmax(out[-1][0][:, :J_CFG.vocab], -1).astype(np.int32)
        jl, jc, jrep = jdec(jp, jc, jnp.asarray(nxt))
        tl, tc, trep = t_rwkv.rwkv_decode(tp, tc, torch.from_numpy(nxt),
                                          None, tctx, T_CFG)
        out.append((np.asarray(jl, np.float32), tl.float().numpy(),
                    _metrics(jrep), _metrics(trep)))
    return out, (jc, tc)


def test_from_jax_keeps_rwkv_layout(weights):
    p = from_jax(weights, device="cpu")
    L, d = T_CFG.n_layers, T_CFG.d_model
    assert p["embed"]["table"].shape == (256, d)
    assert p["embed"]["table"].dtype == torch.int8
    assert p["layers"]["tm"]["wr"]["w_packed"].shape == (L, d, d + 128)
    assert p["layers"]["cm"]["wv"]["w_packed"].shape == (L, 128, d + 128)
    assert p["layers"]["tm"]["bonus"].shape == (L, 4, 16)
    assert p["head"]["w_packed"].shape == (d, 256 + 128)
    np.testing.assert_array_equal(p["layers"]["tm"]["mu"].numpy(),
                                  weights["layers"]["tm"]["mu"])
    # the port's own init has the same tree, shapes and dtypes
    mine = build_model(T_CFG).init(0, quant=True, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    want = {jax.tree_util.keystr(k): (v.shape, v.dtype.name)
            for k, v in flat(weights)[0]}
    got = {jax.tree_util.keystr(k): (tuple(v.shape),
                                     str(v.dtype).removeprefix("torch."))
           for k, v in flat(mine)[0]}
    assert got == want


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_prefill_and_decode_match_jax(weights, dtype):
    out, (jc, tc) = _run_both(weights, _prompt(), dtype)
    for jl, tl, jm, tm in out:
        assert tl.shape == jl.shape == (2, 256)
        assert np.all(np.isfinite(tl))
        assert _scaled_err(tl, jl) <= _TOL[dtype]
        _assert_same_metrics(tm, jm)
        assert tm["abft/qgemm_checks"] == 2 * 7 + 1
        assert tm["abft/embedding_bag_checks"] == 1
        assert tm["abft/qgemm_errors"] == tm["abft/embedding_bag_errors"] == 0
    for k in ("S", "x_tm", "x_cm"):
        assert tc[k].shape == jc[k].shape
        assert _scaled_err(tc[k], jc[k]) <= _TOL[dtype], k


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fault_counters_match_jax_under_flips(weights, dtype):
    tokens = _prompt()
    bad = jax.tree.map(np.copy, weights)
    # one bit of layer 1's cm.wv payload (its checksum lane left stale)
    bad["layers"]["cm"]["wv"]["w_packed"][1, 40, 7] ^= np.int8(0x10)
    # one high bit of a prompt token's embedding row (row sums stale)
    bad["embed"]["table"][int(tokens[0, 5]), 9] ^= np.int8(-128)
    out, _ = _run_both(bad, tokens, dtype, steps=1)
    for _, _, jm, tm in out:
        _assert_same_metrics(tm, jm)
    assert out[0][3]["abft/qgemm_errors"] > 0
    assert out[0][3]["abft/embedding_bag_errors"] >= 1


def test_init_rwkv_distributions():
    p = t_rwkv.init_rwkv(3, T_CFG, quant=True, device="cpu")
    w = p["layers"]["tm"]["wr"]["w_packed"][..., :T_CFG.d_model]
    assert w.dtype == torch.int8 and int(w.min()) >= -127
    a = p["head"]["alpha"]
    assert float(a.min()) >= 1e-3 and float(a.max()) <= 2e-3
    assert "b" not in p["head"]
    e = p["embed"]
    assert float(e["alphas"].min()) >= 5e-3
    assert float(e["betas"].abs().max()) <= 0.1
    mu = p["layers"]["tm"]["mu"]
    assert 0.4 < float(mu.std()) < 0.6               # param() scale 0.5
    lora = p["layers"]["tm"]["w_lora_a"]
    assert 0.015 < float(lora.std()) < 0.025          # param() scale 0.02
    assert torch.equal(p["layers"]["ln1"]["scale"],
                       torch.ones_like(p["layers"]["ln1"]["scale"]))
    from repro_torch.protect import encode_tree
    enc = encode_tree(p)
    assert torch.equal(enc["layers"]["cm"]["wk"]["w_packed"],
                       p["layers"]["cm"]["wk"]["w_packed"])
    assert torch.equal(enc["embed"]["rowsums"], e["rowsums"])
    q = t_rwkv.init_rwkv(3, T_CFG, quant=True, device="cpu")
    assert torch.equal(q["layers"]["cm"]["wv"]["w_packed"],
                       p["layers"]["cm"]["wv"]["w_packed"])


def test_rwkv_and_facade_refuse_what_is_not_ported(monkeypatch):
    import dataclasses
    # the vlm, encdec and hybrid families serve since ROADMAP A7's
    # serving slice; the facade still refuses what it does not run
    for fam, item in (("dlrm", "models.dlrm"), ("rnn", "unknown family")):
        with pytest.raises(NotImplementedError, match=item):
            build_model(dataclasses.replace(T_CFG, family=fam))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        t_rwkv.init_rwkv(0, T_CFG)
