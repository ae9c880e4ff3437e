"""The port's whisper (encoder-decoder) against the JAX package on the same
numpy inputs, at the reduced config: the sinusoid table, cross-attention
(full-sequence and one-token decode over the static cache), the encoder,
and the prefill with 3 greedy decode steps under a bf16-cache and a
``kv_cache:on`` plan, through weights carried by ``from_jax``; then both
serving engines over one burst (``torch_family_parity``).

The JAX side runs op by op (``jax.disable_jit``, ROADMAP §C5).
Tolerances as ``tests/test_torch_lm.py``'s, a share of the reference's
largest magnitude: 1e-5 in float32, 2**-8 in bfloat16, and 2**-5 for a
float32 run whose int8 activation codes may split at a rounding; the
FaultReport counters exact.  The sinusoid table is held to two ulps of
its largest angle (its exponential may round as XLA's does not).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs.reduce import small_arch  # noqa: E402
from repro.core import QuantKV as JQuantKV  # noqa: E402
from repro.core.inject import victim_leaf_index as j_victim  # noqa: E402
from repro.layers import attention as j_att  # noqa: E402
from repro.layers import rope as j_rope  # noqa: E402
from repro.models import base as j_base  # noqa: E402
from repro.models import whisper as j_wh  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.core import QuantKV  # noqa: E402
from repro_torch.core.inject import victim_leaf_index  # noqa: E402
from repro_torch.layers import attention as t_att  # noqa: E402
from repro_torch.layers import rope as t_rope  # noqa: E402
from repro_torch.models import base as t_base  # noqa: E402
from repro_torch.models import whisper as t_wh  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from torch_family_parity import KV_PLAN as _KV_PLAN  # noqa: E402
from torch_family_parity import SPLIT_TOL as _SPLIT_TOL  # noqa: E402
from torch_family_parity import TOL as _TOL  # noqa: E402
from torch_family_parity import ctxs as _ctxs  # noqa: E402
from torch_family_parity import metrics as _metrics  # noqa: E402
from torch_family_parity import same_metrics as _same_metrics  # noqa: E402
from torch_family_parity import scaled_err as _scaled_err  # noqa: E402
from torch_family_parity import (check_run, engine_matches_jax,  # noqa: E402
                                 run_both)
from torch_family_parity import weights as family_weights  # noqa: E402

J_CFG = small_arch("whisper-large-v3")
T_CFG = reduce_cfg(get_arch("whisper-large-v3"))
ARCH = "whisper-large-v3"
MAX_POS = 64                  # torch_family_parity.weights' table
HEADS = dict(n_heads=T_CFG.n_heads, n_kv=T_CFG.n_kv_heads,
             head_dim=T_CFG.head_dim_)


def _tensor(x, dtype):
    return torch.from_numpy(np.ascontiguousarray(x)).to(getattr(torch, dtype))


@pytest.fixture(scope="module")
def weights():
    return family_weights(ARCH, max_pos=MAX_POS)


def test_config_is_the_jax_config():
    assert dataclasses.asdict(T_CFG) == dataclasses.asdict(J_CFG)
    assert (T_CFG.enc_layers, T_CFG.enc_seq) == (2, 12)


@pytest.mark.parametrize("seq,d", [(1500, 1280), (12, 64), (7, 10), (3, 2)])
def test_sinusoid_positions_match_jax(seq, d):
    got = t_rope.sinusoid_positions(seq, d)
    with jax.disable_jit():
        want = np.asarray(j_rope.sinusoid_positions(seq, d))
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    # the inverse frequencies may part from XLA's exp by one ulp, which
    # an angle multiplies by its position: two ulps of the largest angle
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=2.0**-22 * max(seq - 1, 1) + 1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_matches_jax(weights, dtype):
    rng = np.random.default_rng(1)
    w = jax.tree.map(lambda a: a[0], weights["dec"]["layers"]["cross"])
    x = rng.standard_normal((2, 5, T_CFG.d_model)).astype(np.float32)
    mem = rng.standard_normal((2, T_CFG.enc_seq, T_CFG.d_model)).astype(
        np.float32)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32)[None], (2, 5))
    mpos = np.broadcast_to(np.arange(T_CFG.enc_seq, dtype=np.int32)[None],
                           (2, T_CFG.enc_seq))
    jctx, tctx = _ctxs(dtype)
    cdt = jctx.compute_dtype
    jw, tw = jax.tree.map(jnp.asarray, w), from_jax(w, "cpu")
    # use_rope=True too: a cross call never rotates
    for rope in (False, True):
        with jax.disable_jit():
            jy, jr = j_att.attention(
                jw, jnp.asarray(x).astype(cdt), jctx,
                positions=jnp.asarray(pos), use_rope=rope, causal=False,
                x_kv=jnp.asarray(mem).astype(cdt),
                kv_positions=jnp.asarray(mpos), chunk=8, **HEADS)
        ty, tr = t_att.attention(
            tw, _tensor(x, dtype), tctx, positions=torch.from_numpy(
                pos.copy()), use_rope=rope, causal=False,
            x_kv=_tensor(mem, dtype),
            kv_positions=torch.from_numpy(mpos.copy()), chunk=8, **HEADS)
        assert _scaled_err(ty.float(), jy) <= _TOL[dtype]
        _same_metrics(_metrics(tr), _metrics(jr))
    # one-token decode over the static cache: q and o only
    shape = (2, T_CFG.n_kv_heads, T_CFG.enc_seq, T_CFG.head_dim_)
    cache = {k: rng.standard_normal(shape).astype(np.float32)
             for k in ("k", "v")}
    x1 = rng.standard_normal((2, T_CFG.d_model)).astype(np.float32)
    dpos = np.array([3, 40], np.int32)
    with jax.disable_jit():
        jy, jc, jr = j_att.attention_decode(
            jw, jnp.asarray(x1).astype(cdt),
            {k: jnp.asarray(v).astype(cdt) for k, v in cache.items()},
            jnp.asarray(dpos), jctx, use_rope=False, cross=True, **HEADS)
    tcache = {k: _tensor(v, dtype) for k, v in cache.items()}
    ty, tc, tr = t_att.attention_decode(
        tw, _tensor(x1, dtype), tcache, torch.from_numpy(dpos), tctx,
        use_rope=False, cross=True, **HEADS)
    assert _scaled_err(ty.float(), jy) <= _TOL[dtype]
    assert tc is tcache
    tm = _metrics(tr)
    _same_metrics(tm, _metrics(jr))
    assert tm["abft/qgemm_checks"] == 2 and tm["abft/kv_cache_checks"] == 0


def test_whisper_tree_and_victims_are_the_jax_ones(weights):
    mine = t_base.build_model(T_CFG, max_pos=MAX_POS).init(
        0, quant=True, device="cpu")
    flat = jax.tree_util.tree_flatten_with_path
    want = {jax.tree_util.keystr(k): (v.shape, v.dtype.name)
            for k, v in flat(weights)[0]}
    got = {jax.tree_util.keystr(k): (tuple(v.shape),
                                     str(v.dtype).removeprefix("torch."))
           for k, v in flat(mine)[0]}
    assert got == want
    for pat in (None, "mlp.down", "dec.layers.mlp.down", "cross.wk",
                "enc.layers.attn.wq", "head", "embed.table"):
        assert victim_leaf_index(mine, pat) == j_victim(weights, pat)
    jc = j_base.Model(J_CFG, max_pos=MAX_POS).init_cache(3, 40)
    tc = t_base.Model(T_CFG, max_pos=MAX_POS).init_cache(3, 40,
                                                         device="cpu")
    for part in ("self", "cross"):
        for k in ("k", "v"):
            assert tuple(tc[part][k].shape) == jc[part][k].value.shape
            assert tc[part][k].dtype == torch.bfloat16


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_encode_matches_jax(weights, dtype):
    frames = np.random.default_rng(2).standard_normal(
        (2, T_CFG.enc_seq, T_CFG.d_model)).astype(np.float32)
    jctx, tctx = _ctxs(dtype)
    with jax.disable_jit():
        jm, jr = j_wh.encode(jax.tree.map(jnp.asarray, weights),
                             jnp.asarray(frames), jctx, J_CFG)
    tm, tr = t_wh.encode(from_jax(weights, "cpu"), torch.from_numpy(frames),
                         tctx, T_CFG)
    assert tm.dtype == getattr(torch, dtype)
    tol = _SPLIT_TOL if dtype == "float32" else _TOL[dtype]
    assert _scaled_err(tm.float(), jm) <= tol
    _same_metrics(_metrics(tr), _metrics(jr))
    assert _metrics(tr)["abft/qgemm_checks"] == 6 * T_CFG.enc_layers


def _to_jax(tree):
    if isinstance(tree, dict):
        return {k: _to_jax(v) for k, v in tree.items()}
    if isinstance(tree, QuantKV):
        return JQuantKV(*(_to_jax(v) for v in tree))
    t = tree.detach()
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("dtype,plan_text", [
    ("float32", "*:policy=log"), ("bfloat16", "*:policy=log"),
    ("float32", _KV_PLAN), ("bfloat16", _KV_PLAN)])
def test_whisper_prefill_and_decode_match_jax(weights, dtype, plan_text):
    out, (jc, tc) = run_both(ARCH, dtype, plan_text, weights)
    quant = plan_text == _KV_PLAN
    L = T_CFG.n_layers
    # prefill: 6 an encoder layer, 12 a decoder layer (4 self, 4 cross, 2
    # MLP and the cache's cross.wk / cross.wv), the head; decode: 4 self
    # + 2 cross + 2 MLP a layer, the head
    check_run(out, dtype, (6 * T_CFG.enc_layers + 12 * L + 1, 8 * L + 1),
              L if quant else 0)
    assert isinstance(tc["self"]["k"], QuantKV) == quant
    tol = _SPLIT_TOL if dtype == "float32" else _TOL[dtype]
    for k in ("k", "v"):
        assert tc["cross"][k].dtype == getattr(torch, dtype)
        assert tuple(tc["cross"][k].shape) == (
            L, 1, T_CFG.n_kv_heads, T_CFG.enc_seq, T_CFG.head_dim_)
        assert _scaled_err(tc["cross"][k].float(),
                           np.asarray(jc["cross"][k], np.float32)) <= tol


def test_decode_past_the_position_table_reads_its_last_row(weights):
    # a retired slot's position keeps counting: JAX's gather clamps it
    out, _ = run_both(ARCH, "bfloat16", "*:policy=log", weights, steps=2,
                      pos0=np.array([MAX_POS + 5], np.int32))
    for jl, tl, jm, tm in out[1:]:
        assert _scaled_err(tl, jl) <= _TOL["bfloat16"]
        _same_metrics(tm, jm)


def test_engine_matches_jax_engine():
    engine_matches_jax(ARCH)


def test_fault_counters_match_jax_under_flips(weights):
    bad = jax.tree.map(np.copy, weights)
    # one bit of the decoder's layer-1 mlp.down payload and one of the
    # encoder's layer-0 attn.wq
    bad["dec"]["layers"]["mlp"]["down"]["w_packed"][1, 40, 7] ^= np.int8(16)
    bad["enc"]["layers"]["attn"]["wq"]["w_packed"][0, 3, 9] ^= np.int8(4)
    out, (jc, tc) = run_both(ARCH, "bfloat16", _KV_PLAN, bad, steps=1)
    for _, _, jm, tm in out:
        _same_metrics(tm, jm)
        assert tm["abft/qgemm_errors"] > 0
    # a flipped int8 payload bit of the self cache: one error at the next
    # decode read, in both packages
    q = tc["self"]["v"].q.clone()
    q[0, 0, 0, 3, 2] ^= 0x08
    t_cache = {"self": {"k": tc["self"]["k"],
                        "v": tc["self"]["v"]._replace(q=q)},
               "cross": tc["cross"]}
    jctx, tctx = _ctxs("bfloat16", _KV_PLAN)
    nxt, pos = np.array([1], np.int32), np.array([17], np.int32)
    with jax.disable_jit():
        _, _, jr = j_wh.whisper_decode(jax.tree.map(jnp.asarray, weights),
                                       _to_jax(t_cache), jnp.asarray(nxt),
                                       jnp.asarray(pos), jctx, J_CFG)
    _, _, tr = t_wh.whisper_decode(from_jax(weights, "cpu"), t_cache,
                                   torch.from_numpy(nxt),
                                   torch.from_numpy(pos), tctx, T_CFG)
    _same_metrics(_metrics(tr), _metrics(jr))
    assert _metrics(tr)["abft/kv_cache_errors"] == 1
    assert _metrics(tr)["abft/qgemm_errors"] == 0
