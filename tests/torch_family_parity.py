"""Helpers shared by the port's parity tests of ROADMAP §A7's families
(``tests/test_torch_{families,mamba,whisper}.py`` and
``tests/test_torch_train_*.py``): the reduced configs and JAX weights, a
prefill with greedy decodes through both packages, both serving engines
over one burst, and the training loss and gradients of both packages.

The JAX side runs op by op (``jax.disable_jit``, ROADMAP §C5), which
compiles every primitive once per shape and dtype in a process: the
model runs take the engine runs' shapes (a batch-1 prompt of
:data:`PROMPT` tokens, the engine's cache length, float32), so one
family's primitives compile once for both.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.reduce import small_arch
from repro.core.inject import victim_leaf_index as j_victim
from repro.layers.common import Ctx as JCtx
from repro.models import base as j_base
from repro.models import lm as j_lm
from repro.models import whisper as j_wh
from repro.protect import default_plan as j_default_plan
from repro.protect.plan import ProtectionPlan as JPlan
from repro.serving import ServingEngine as JEngine
from repro.serving import TenantSpec as JTenant
from repro.serving import chat_stream as j_chat_stream
from repro.sharding import values_of
from repro_torch.configs import get_arch, reduce_cfg
from repro_torch.core.inject import victim_leaf_index
from repro_torch.launch.parity import (grad_scale, grad_tolerance,
                                       loss_tolerance)
from repro_torch.layers.common import Ctx as TCtx
from repro_torch.models import base as t_base
from repro_torch.models.convert import from_jax
from repro_torch.protect import ProtectionPlan, default_plan
from repro_torch.serving import ServingEngine, TenantSpec, chat_stream

#: tests/test_torch_lm.py's tolerances, a share of the reference's
#: largest magnitude; 2**-5 for a float32 run after an int8 code split
TOL = {"float32": 1e-5, "bfloat16": 2.0**-8}
SPLIT_TOL = 2.0**-5
KV_PLAN = "*:policy=recompute,kv_cache:on"
#: the engine runs' prompt bucket and new tokens; the model runs' too
PROMPT, NEW = 16, 3


def np_tree(tree):
    return jax.tree.map(np.asarray, values_of(tree))


def scaled_err(got, want):
    want = np.asarray(want, np.float32)
    got = np.asarray(got, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-6))


def metrics(rep):
    return {k: int(v) for k, v in rep.as_metrics().items()}


def same_metrics(tm, jm):
    # other test modules may register extra JAX op kinds in this process;
    # those keys stay zero
    assert set(tm) <= set(jm)
    assert all(jm[k] == 0 for k in set(jm) - set(tm))
    assert tm == {k: jm[k] for k in tm}


def plans(plan_text):
    return (j_default_plan().with_rules(*JPlan.from_any(plan_text).rules),
            default_plan().with_rules(
                *ProtectionPlan.from_any(plan_text).rules))


def ctxs(dtype, plan_text="*:policy=log"):
    jp, tp = plans(plan_text)
    return (JCtx(quant=True, compute_dtype=getattr(jnp, dtype), plan=jp),
            TCtx(quant=True, compute_dtype=getattr(torch, dtype), plan=tp))


def cfgs(arch):
    """The reduced config in both packages.  The reduced hymba's two
    layers are its first and last, both global: a third layer (layer 1
    of 3) slides its 8-token window, so a 16-token prompt after 4 meta
    tokens reaches past the window and the prefix_global mask."""
    j, t = small_arch(arch), reduce_cfg(get_arch(arch))
    if arch == "hymba-1.5b":
        j, t = (dataclasses.replace(c, n_layers=3) for c in (j, t))
    return j, t


_WEIGHTS = {}


def weights(arch, max_pos=64):
    """The JAX package's int8 weights of :func:`cfgs`'s model, seed 0, as
    numpy (whisper's position table ``max_pos`` rows)."""
    if arch not in _WEIGHTS:
        cfg = cfgs(arch)[0]
        if cfg.family == "encdec":
            init = jax.jit(lambda k: j_wh.init_whisper(k, cfg, max_pos,
                                                       quant=True))
        else:
            init = jax.jit(lambda k: j_lm.init_lm(k, cfg, quant=True))
        _WEIGHTS[arch] = np_tree(init(jax.random.key(0)))
    return _WEIGHTS[arch]


def cache_len(cfg) -> int:
    """The engine's: prompt, new tokens, a margin of 8 and the patches
    (the meta tokens the cache adds itself)."""
    return PROMPT + NEW + 8 + cfg.n_patches


def run_both(arch, dtype, plan_text, np_params=None, steps=NEW, pos0=None):
    """Prefill a batch-1 prompt then ``steps`` greedy decodes through both
    packages (both fed the JAX package's token).  Per step: (jax logits,
    port logits, jax metrics, port metrics); and the final caches."""
    j_cfg, t_cfg = cfgs(arch)
    w = weights(arch) if np_params is None else np_params
    jctx, tctx = ctxs(dtype, plan_text)
    jp, tp = jax.tree.map(jnp.asarray, w), from_jax(w, "cpu")
    max_pos = w["dec"]["pos"].shape[0] if t_cfg.family == "encdec" else 0
    jm = j_base.Model(j_cfg, max_pos=max_pos or 4096)
    tm = t_base.Model(t_cfg, max_pos=max_pos or 4096)
    rng = np.random.default_rng(11)
    batch = {"tokens": rng.integers(0, t_cfg.vocab, (1, PROMPT)).astype(
        np.int32)}
    if t_cfg.patch_dim:
        batch["patches"] = rng.standard_normal(
            (1, t_cfg.n_patches, t_cfg.patch_dim)).astype(np.float32)
    if t_cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (1, t_cfg.enc_seq, t_cfg.d_model)).astype(np.float32)
    n = cache_len(t_cfg)
    with jax.disable_jit():
        jl, jc, jr = jm.prefill(jp, jax.tree.map(jnp.asarray, batch), jctx,
                                n)
    tl, tc, tr = tm.prefill(tp, from_jax(batch, "cpu"), tctx, n)
    out = [(np.asarray(jl, np.float32), tl.float().numpy(), metrics(jr),
            metrics(tr))]
    pos = np.full((1,), PROMPT + t_cfg.meta_tokens + t_cfg.n_patches,
                  np.int32) if pos0 is None else pos0
    for _ in range(steps):
        nxt = np.argmax(out[-1][0][:, :t_cfg.vocab], -1).astype(np.int32)
        with jax.disable_jit():
            jl, jc, jr = jm.decode(jp, jc, jnp.asarray(nxt),
                                   jnp.asarray(pos), jctx)
        tl, tc, tr = tm.decode(tp, tc, torch.from_numpy(nxt),
                               torch.from_numpy(pos), tctx)
        pos = pos + 1
        out.append((np.asarray(jl, np.float32), tl.float().numpy(),
                    metrics(jr), metrics(tr)))
    return out, (jc, tc)


def check_run(out, dtype, k1, kv_reads):
    """Each step's logits within the tolerance (2**-5 in float32, where
    a code may split), its counters JAX's, ``k1`` = (prefill, decode) K1
    checks, ``kv_reads`` kv_cache checks a decode step, no error."""
    tol = SPLIT_TOL if dtype == "float32" else TOL[dtype]
    for i, (jl, tl, jm, tm) in enumerate(out):
        assert tl.shape == jl.shape
        assert np.all(np.isfinite(tl))
        assert scaled_err(tl, jl) <= tol, i
        same_metrics(tm, jm)
        assert tm["abft/qgemm_checks"] == k1[min(i, 1)], i
        assert tm["abft/embedding_bag_checks"] == 1
        assert tm["abft/kv_cache_checks"] == (kv_reads if i else 0)
        assert tm["abft/qgemm_errors"] == tm["abft/kv_cache_errors"] == 0


def check_tree(arch, mine, patterns):
    """The port's parameter tree has JAX's paths, shapes and dtypes, and
    each victim pattern picks JAX's leaf (or matches none in both)."""
    w = weights(arch)
    flat = jax.tree_util.tree_flatten_with_path
    want = {jax.tree_util.keystr(k): (v.shape, v.dtype.name)
            for k, v in flat(w)[0]}
    got = {jax.tree_util.keystr(k): (tuple(v.shape),
                                     str(v.dtype).removeprefix("torch."))
           for k, v in flat(mine)[0]}
    assert got == want
    for pat in (None,) + tuple(patterns):
        try:
            j = j_victim(w, pat)
        except ValueError:
            with pytest.raises(ValueError, match="matches no leaf"):
                victim_leaf_index(mine, pat)
            continue
        assert victim_leaf_index(mine, pat) == j


def _stream(fn, n=3):
    # at 1e6 requests/s every arrival lands inside one engine step on
    # either package
    return fn(n, tenants={"b": 1.0}, rate_rps=1e6, seed=0, mean_prompt=8,
              max_prompt=PROMPT, mean_output=2, max_output=NEW)


def engine_matches_jax(arch):
    """Both engines, float32, one ``kv_cache:on`` + ``recompute`` lane of
    2 slots, serve the same burst of 3 requests: the same cache length,
    positions, tokens, steps and counters, and no error."""
    j_kv, t_kv = plans(KV_PLAN)
    j_eng = JEngine(small_arch(arch),
                    [JTenant("b", dataclasses.replace(j_kv, name="b"))],
                    n_slots=2, max_prompt=PROMPT, max_new_tokens=NEW,
                    compute_dtype=jnp.float32)
    with jax.disable_jit():
        j_tel = j_eng.run(_stream(j_chat_stream))
    eng = ServingEngine(reduce_cfg(get_arch(arch)),
                        [TenantSpec("b", dataclasses.replace(t_kv,
                                                             name="b"))],
                        n_slots=2, max_prompt=PROMPT, max_new_tokens=NEW,
                        compute_dtype=torch.float32, device="cpu")
    assert eng.cache_len == j_eng.cache_len
    assert eng.model.max_pos == j_eng.model.max_pos == eng.cache_len + 8
    assert eng._prefill_pos() == j_eng._prefill_pos()
    eng.params = from_jax(jax.tree.map(np.asarray, j_eng.params),
                          device="cpu")
    tel = eng.run(_stream(chat_stream))
    assert {r.rid: r.tokens for r in tel.requests} == \
        {r.rid: r.tokens for r in j_tel.requests}
    assert [(e.step, e.kind, e.lane, e.slot_rids, e.errors)
            for e in tel.steps] == \
        [(e.step, e.kind, e.lane, e.slot_rids, e.errors)
         for e in j_tel.steps]
    counters = tel.summary()["faults"]["counters"]
    j_counters = j_tel.summary()["faults"]["counters"]
    assert all(j_counters[k] == 0 for k in set(j_counters) - set(counters))
    assert counters == {k: j_counters[k] for k in counters}
    assert counters["qgemm_checks"] > 0 and counters["kv_cache_checks"] > 0
    assert not any(v for k, v in counters.items()
                   if not k.endswith("_checks"))
    return tel


# ------------------------------ training ------------------------------------

def same_metric_keys(tmet, jmet):
    """The port's metric keys are JAX's, but for the counters of op kinds
    another test registered in this process on one side only
    (``register_op_kind`` is process-wide)."""
    from repro.core.policy import op_kinds as j_kinds
    from repro_torch.core.policy import op_kinds as t_kinds
    only_j = set(j_kinds()) - set(t_kinds())
    only_t = set(t_kinds()) - set(j_kinds())

    def own(keys, others):
        return {k for k in keys
                if not any(k.startswith(f"abft/{o}_") for o in others)}
    assert own(tmet, only_t) == own(jmet, only_j)


def train_cfgs(arch):
    """The reduced config of ``tests/helpers.reduce_cfg`` in both
    packages (the train CLI's ``--smoke``)."""
    return small_arch(arch), reduce_cfg(get_arch(arch))


def train_batch(cfg, seed: int, b: int = 2, s: int = 16) -> dict:
    """A numpy training batch of ``s`` text tokens: tokens, next-token
    labels, and llava's patches or whisper's frames."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.patch_dim:
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return batch


_TRAIN_W = {}


def train_weights(arch, seed: int, max_pos: int = 64):
    """JAX's float parameters of the reduced model from ``seed``, as
    numpy (whisper's position table ``max_pos`` rows)."""
    key = (arch, seed, max_pos)
    if key not in _TRAIN_W:
        jm = j_base.Model(train_cfgs(arch)[0], max_pos=max_pos)
        _TRAIN_W[key] = np_tree(jax.jit(lambda k: jm.init(k))(
            jax.random.key(seed)))
    return _TRAIN_W[key]


_JAX_GRAD = {}


def jax_value_and_grad(arch, dtype: str, np_params, batch, max_pos=64,
                       **ctx_kw):
    """``jax.value_and_grad(Model.loss)`` of the reduced model: jitted in
    float32 (the training path has no quantizer, so jit moves nothing
    §C5 speaks of), op by op in bf16 (XLA's fusions keep float32
    intermediates an op-by-op run rounds).  -> (loss, metrics,
    [(dotted path, gradient)] in the flatten order)."""
    jm = j_base.Model(train_cfgs(arch)[0], max_pos=max_pos)
    jctx = JCtx(plan=j_default_plan(), quant=False,
                compute_dtype=getattr(jnp, dtype), **ctx_kw)

    def loss_fn(p, b):
        loss, (metrics, _rep) = jm.loss(p, b, jctx)
        return loss, metrics

    fn = jax.value_and_grad(loss_fn, has_aux=True)
    jp = jax.tree.map(jnp.asarray, np_params)
    jb = jax.tree.map(jnp.asarray, batch)
    if dtype == "float32":
        key = (arch, max_pos, tuple(sorted(ctx_kw.items())))
        if key not in _JAX_GRAD:
            _JAX_GRAD[key] = jax.jit(fn)
        (loss, metrics), grads = _JAX_GRAD[key](jp, jb)
    else:
        with jax.disable_jit():
            (loss, metrics), grads = fn(jp, jb)
    leaves = [(".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                        for k in path), np.asarray(g, np.float32))
              for path, g in jax.tree_util.tree_flatten_with_path(grads)[0]]
    return float(loss), {k: float(v) for k, v in metrics.items()}, leaves


def port_value_and_grad(arch, dtype: str, np_params, batch, max_pos=64,
                        **ctx_kw):
    """The port's ``make_grad_fn(Model.loss)`` on the same weights and
    batch: -> (loss, metrics, [(dotted path, gradient)])."""
    from repro_torch.core.inject import leaf_paths
    from repro_torch.launch.steps import make_grad_fn
    tm = t_base.Model(train_cfgs(arch)[1], max_pos=max_pos)
    ctx = TCtx(plan=default_plan(), quant=False,
               compute_dtype=getattr(torch, dtype), **ctx_kw)
    (loss, metrics), grads = make_grad_fn(tm, ctx)(
        from_jax(np_params, "cpu"), from_jax(batch, "cpu"))
    return float(loss), {k: float(v) for k, v in metrics.items()}, \
        [(p, g.to(torch.float32).numpy()) for p, g in leaf_paths(grads)]


def check_loss_and_grads(arch, dtype: str, seed: int, tol=None, **ctx_kw):
    """Both packages' loss and every gradient leaf on JAX's weights and
    the same batch, within :func:`loss_tolerance` and ``tol`` (default
    :func:`grad_tolerance`).  Returns (jax loss and metrics, port loss and
    metrics)."""
    cfg = train_cfgs(arch)[1]
    w = train_weights(arch, seed)
    batch = train_batch(cfg, seed)
    jl, jmet, jg = jax_value_and_grad(arch, dtype, w, batch, **ctx_kw)
    tl, tmet, tg = port_value_and_grad(arch, dtype, w, batch, **ctx_kw)
    assert np.isfinite(tl) and \
        abs(tl - jl) <= loss_tolerance(cfg, dtype) * abs(jl)
    same_metric_keys(tmet, jmet)
    assert [p for p, _ in tg] == [p for p, _ in jg]
    scales = dict(jg)
    tol = grad_tolerance(cfg, dtype) if tol is None else tol
    for (path, a), (_, b) in zip(jg, tg):
        assert b.shape == a.shape, path
        err = float(np.abs(a - b).max()) / grad_scale(path, scales)
        assert err <= tol, (path, err, tol)
    return (jl, jmet), (tl, tmet)
