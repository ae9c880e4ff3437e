"""The port's Mamba branch (hymba's SSM heads) against the JAX package on
the same numpy inputs: the parameter tree, the causal conv, the prefill
output with its conv and SSM states, decode steps from those states, and
JAX's two-level (``ssm_chunk``) scan, which is the plain scan's result.
Then the reduced hymba-1.5b (with a third layer, whose window slides:
``torch_family_parity.cfgs``): its tree and victims, its prefill and 3
greedy decodes in float32 under a bf16-cache and a ``kv_cache:on`` plan
(logits within 2**-5, the float32 split allowance; the SSM state within
it too), and both serving engines over one burst, as
``tests/test_torch_families.py`` holds the other families.

The JAX side runs op by op (``jax.disable_jit``), so its quantizers
divide as the port's do (ROADMAP §C5).  Tolerances as
``tests/test_torch_lm.py``'s: a share of the reference's largest
magnitude, 1e-5 in float32 and 2**-8 in bfloat16; the FaultReport
counters exact.  A float32 run rounds ``x_proj``'s and ``out_proj``'s
inputs to int8 codes, where a last-bit difference upstream (silu,
softplus, the scan's sums) can land on the other side of a rounding
split, so its outputs are held to 2**-5 (measured <= 8e-7: no split at
these inputs); the float32 conv and SSM states to 1e-5 in either compute
dtype (measured <= 2.1e-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduce import small_arch  # noqa: E402
from repro.layers import mamba as j_mam  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.layers import mamba as t_mam  # noqa: E402
from repro_torch.layers.common import Ctx as TCtx  # noqa: E402
from repro_torch.models import base as t_base  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from torch_family_parity import SPLIT_TOL as _SPLIT_TOL  # noqa: E402
from torch_family_parity import TOL as _TOL  # noqa: E402
from torch_family_parity import metrics as _metrics  # noqa: E402
from torch_family_parity import same_metrics as _same_metrics  # noqa: E402
from torch_family_parity import scaled_err as _scaled_err  # noqa: E402
from torch_family_parity import (KV_PLAN, PROMPT, cfgs,  # noqa: E402
                                 check_run, check_tree, engine_matches_jax,
                                 np_tree, run_both, weights)

J_CFG = small_arch("hymba-1.5b")
T_CFG = reduce_cfg(get_arch("hymba-1.5b"))
DI, N = T_CFG.d_inner_, T_CFG.ssm_state


@pytest.fixture(scope="module")
def params():
    return np_tree(jax.jit(lambda k: j_mam.init_mamba(
        k, T_CFG.d_model, DI, N, quant=True))(jax.random.key(3)))


def _ctxs(dtype, **jkw):
    return (JCtx(quant=True, compute_dtype=getattr(jnp, dtype), **jkw),
            TCtx(quant=True, compute_dtype=getattr(torch, dtype)))


def _cache(rng, batch, zero=False):
    conv = rng.standard_normal((batch, t_mam.CONV_K - 1, DI)) * 0.5
    h = rng.standard_normal((batch, DI, N)) * 0.1
    if zero:
        conv, h = conv * 0, h * 0
    return {"conv": conv.astype(np.float32), "h": h.astype(np.float32)}


def test_mamba_tree_matches_jax(params):
    mine = t_mam.init_mamba(torch.Generator().manual_seed(0),
                            T_CFG.d_model, DI, N, quant=True, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    want = {jax.tree_util.keystr(k): (v.shape, v.dtype.name)
            for k, v in flat(params)[0]}
    got = {jax.tree_util.keystr(k): (tuple(v.shape),
                                     str(v.dtype).removeprefix("torch."))
           for k, v in flat(mine)[0]}
    assert got == want
    # the constant leaves are JAX's values
    for k in ("a_log", "d_skip"):
        np.testing.assert_array_equal(mine[k].numpy(), params[k])
    np.testing.assert_array_equal(mine["dt_proj"]["b"].numpy(),
                                  params["dt_proj"]["b"])
    jc = j_mam.init_mamba_cache(3, DI, N)
    tc = t_mam.init_mamba_cache(3, DI, N, device="cpu")
    for k in ("conv", "h"):
        assert tuple(tc[k].shape) == jc[k].value.shape
        assert tc[k].dtype == torch.float32 and not tc[k].any()


def test_causal_conv_matches_jax():
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 7, DI)).astype(np.float32)
    w = rng.standard_normal((t_mam.CONV_K, DI)).astype(np.float32)
    st = _cache(rng, 2)["conv"]
    with jax.disable_jit():
        jy, js = j_mam._causal_conv(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(st))
    ty, ts = t_mam._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                                torch.from_numpy(st))
    assert _scaled_err(ty, jy) <= _TOL["float32"]
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("zero", [True, False])
def test_mamba_prefill_and_decode_states_match_jax(params, dtype, zero):
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((2, 9, T_CFG.d_model)) * 2).astype(np.float32)
    cache = _cache(rng, 2, zero)
    jctx, tctx = _ctxs(dtype)
    jp, tp = jax.tree.map(jnp.asarray, params), from_jax(params, "cpu")
    cdt = getattr(torch, dtype)
    split = _SPLIT_TOL if dtype == "float32" else _TOL[dtype]

    with jax.disable_jit():
        jy, jc, jr = j_mam.mamba(jp, jnp.asarray(x).astype(jctx.compute_dtype),
                                 jax.tree.map(jnp.asarray, cache), jctx,
                                 d_inner=DI, n_state=N)
    ty, tc, tr = t_mam.mamba(tp, torch.from_numpy(x).to(cdt),
                             from_jax(cache, "cpu"), tctx, d_inner=DI,
                             n_state=N)
    assert ty.dtype == cdt and ty.shape == (2, 9, T_CFG.d_model)
    assert _scaled_err(ty.float(), jy) <= split
    np.testing.assert_array_equal(tc["conv"].numpy(), np.asarray(jc["conv"]))
    assert _scaled_err(tc["h"], jc["h"]) <= _TOL["float32"]
    _same_metrics(_metrics(tr), _metrics(jr))
    assert _metrics(tr)["abft/qgemm_checks"] == 3
    # three one-token decode steps from the prefill's states
    for t in range(3):
        xt = (rng.standard_normal((2, 1, T_CFG.d_model)) * 2).astype(
            np.float32)
        with jax.disable_jit():
            jy, jc, jr = j_mam.mamba(
                jp, jnp.asarray(xt).astype(jctx.compute_dtype), jc, jctx,
                d_inner=DI, n_state=N)
        ty, tc, tr = t_mam.mamba(tp, torch.from_numpy(xt).to(cdt), tc, tctx,
                                 d_inner=DI, n_state=N)
        assert _scaled_err(ty.float(), jy) <= split, t
        assert _scaled_err(tc["h"], jc["h"]) <= _TOL["float32"], t
        assert _scaled_err(tc["conv"], jc["conv"]) <= _TOL["float32"], t
        _same_metrics(_metrics(tr), _metrics(jr))


def test_jax_chunked_scan_is_the_plain_scan(params):
    """JAX's ``ssm_chunk`` remat gives the plain scan's result, which the
    port's single scan matches."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((1, 12, T_CFG.d_model)).astype(np.float32)
    cache = _cache(rng, 1)
    jctx, tctx = _ctxs("float32", ssm_chunk=4)
    jp = jax.tree.map(jnp.asarray, params)
    with jax.disable_jit():
        jy, jc, _ = j_mam.mamba(jp, jnp.asarray(x),
                                jax.tree.map(jnp.asarray, cache), jctx,
                                d_inner=DI, n_state=N)
        py, pc, _ = j_mam.mamba(jp, jnp.asarray(x),
                                jax.tree.map(jnp.asarray, cache),
                                jctx.__class__(quant=True,
                                               compute_dtype=jnp.float32),
                                d_inner=DI, n_state=N)
    np.testing.assert_array_equal(np.asarray(jy), np.asarray(py))
    np.testing.assert_array_equal(np.asarray(jc["h"]), np.asarray(pc["h"]))
    ty, tc, _ = t_mam.mamba(from_jax(params, "cpu"), torch.from_numpy(x),
                            from_jax(cache, "cpu"), tctx, d_inner=DI,
                            n_state=N)
    assert _scaled_err(ty, jy) <= _SPLIT_TOL
    assert _scaled_err(tc["h"], jc["h"]) <= _SPLIT_TOL


# ------------------------------ the reduced hymba -----------------------------

HYMBA = "hymba-1.5b"


def test_hymba_tree_victims_and_cache_are_the_jax_ones():
    j_cfg, cfg = cfgs(HYMBA)
    check_tree(HYMBA, t_base.build_model(cfg).init(0, quant=True,
                                                   device="cpu"),
               ("attn.wq", "mlp.down", "ssm.out_proj", "ssm.in_proj",
                "ssm.x_proj", "ssm.conv_w", "meta", "embed.table"))
    from repro.models import base as j_base
    jc = j_base.Model(j_cfg).init_cache(3, 40)
    tc = t_base.Model(cfg).init_cache(3, 40, device="cpu")
    assert set(tc) == set(jc) == {"attn", "ssm"}
    for part, keys in (("attn", ("k", "v")), ("ssm", ("conv", "h"))):
        for k in keys:
            assert tuple(tc[part][k].shape) == jc[part][k].value.shape


@pytest.mark.parametrize("plan_text", ["*:policy=log", KV_PLAN])
def test_hymba_prefill_and_decode_match_jax(plan_text):
    cfg = cfgs(HYMBA)[1]
    out, (jc, tc) = run_both(HYMBA, "float32", plan_text)
    # 4 attention, 3 SSM and 3 MLP projections a layer, and the head
    per_step = 10 * cfg.n_layers + 1
    check_run(out, "float32", (per_step, per_step),
              cfg.n_layers if plan_text == KV_PLAN else 0)
    for k in ("conv", "h"):
        assert tc["ssm"][k].dtype == torch.float32
        assert _scaled_err(tc["ssm"][k], jc["ssm"][k]) <= _SPLIT_TOL


def test_hymba_windows_and_meta_tokens_bite():
    """The 3-layer reduced hymba slides an 8-token window at layer 1 (the
    registry's 2-layer one has only global layers) and keeps its 4 meta
    tokens visible; the meta tokens move every position's output."""
    cfg = cfgs(HYMBA)[1]
    assert t_lm._windows(T_CFG) == [None, None]
    assert t_lm._windows(cfg) == [None, 8, None]
    assert cfg.meta_tokens + PROMPT > cfg.sliding_window + cfg.meta_tokens
    p = from_jax(weights(HYMBA), "cpu")
    ctx = TCtx(quant=True, compute_dtype=torch.float32)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (1, PROMPT)).astype(np.int32))
    x0, _, _, _ = t_lm.lm_hidden(p, tokens, ctx, cfg)
    x1, _, _, _ = t_lm.lm_hidden({**p, "meta": p["meta"] + 1}, tokens, ctx,
                                 cfg)
    assert x0.shape == (1, cfg.meta_tokens + PROMPT, cfg.d_model)
    assert not torch.equal(x0[:, -1], x1[:, -1])


def test_hymba_engine_matches_jax_engine():
    tel = engine_matches_jax(HYMBA)
    # the SSM state rides in the lane's cache beside the attention's
    assert tel.summary()["faults"]["counters"]["qgemm_checks"] % 21 == 0
