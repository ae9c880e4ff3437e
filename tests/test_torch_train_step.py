"""The port's training forward, loss, gradients and train step
(``repro_torch.models``, ``repro_torch.launch.steps``,
``repro_torch.launch.train``) against the JAX package's, on the CPU,
over the reduced Llama-3.2-1B and the same numpy inputs.

* Loss and gradient against ``jax.value_and_grad(model.loss)`` run op by
  op.  The attention takes bf16 operands in both packages (float32
  sums), so its backward rounds cotangents to bf16: a float32 sum-order
  difference upstream (a GEMM, a cosine of the rope) flips a bf16
  rounding now and then, and the leaves the attention's backward reaches
  differ by up to a bf16 ulp of an element (ROADMAP §C10).  Every leaf
  is held to 2^-7 of its largest magnitude, in float32 and bf16
  compute, and the loss to 1e-5 (f32).  What is not bf16 is held
  tighter: the flash attention's gradients are bit-exact on the same
  inputs, and the MLP and RMSNorm gradients within 1e-5 in float32.
* The train step's composition (microbatch accumulation, metrics
  averaging, compression, clipping, the schedule, AdamW) is bit-exact
  with JAX's ``make_train_step`` given the same gradients; with clipping
  active the norm's sum order moves the result by float32 ulps.
* The float ``Model.init``, ``input_specs`` and ``train_state_shapes``
  give JAX's tree, shapes and dtypes; MoE and RWKV train (held to JAX
  in ``tests/test_torch_train_*.py``); the CLI trains the smoke model on the CPU with 0
  ``comm/errors``, trains it on a data mesh of 4 ranks and refuses a
  model axis naming A8.4.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import reduce_cfg as j_reduce  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.configs.registry import get_arch as j_arch  # noqa: E402
from repro.launch import steps as jsteps  # noqa: E402
from repro.layers import attention as jattn  # noqa: E402
from repro.layers import mlp as jmlp  # noqa: E402
from repro.layers import norms as jnorms  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.models.base import build_model as j_build  # noqa: E402
from repro.protect import default_plan as j_plan  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.configs import get_arch, reduce_cfg  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import steps as tsteps  # noqa: E402
from repro_torch.layers import attention as tattn  # noqa: E402
from repro_torch.layers import mlp as tmlp  # noqa: E402
from repro_torch.layers import norms as tnorms  # noqa: E402
from repro_torch.layers.common import Ctx  # noqa: E402
from repro_torch.models.base import build_model  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402
from repro_torch.protect import default_plan  # noqa: E402
from repro_torch.runtime.compression import CompressionState  # noqa: E402

J_CFG = j_reduce(j_arch("llama3.2-1b"))


def _same_metric_keys(tmet, jmet):
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
T_CFG = reduce_cfg(get_arch("llama3.2-1b"))
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture(scope="module")
def models():
    return j_build(J_CFG, max_pos=64), build_model(T_CFG)


def _params(jm, seed):
    jp = values_of(jm.init(jax.random.key(seed)))
    return jp, from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _batch(seed, b=2, s=16):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, T_CFG.vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def _rel(a, b):
    a = np.asarray(a, np.float32)
    b = np.asarray(b, np.float32)
    return float(np.abs(a - b).max() / max(np.abs(a).max(), 1e-30))


_GRADS = {}


def _value_and_grad(jm, jd):
    """JAX's loss and gradient, as ``jax.value_and_grad`` of ``loss``."""
    jctx = JCtx(plan=j_plan(), quant=False, compute_dtype=jd)

    def loss_fn(p, b):
        loss, (metrics, _rep) = jm.loss(p, b, jctx)
        return loss, metrics

    return jax.value_and_grad(loss_fn, has_aux=True)


def _jit_grad(jm, jd):
    """:func:`_value_and_grad` jitted.  In float32 the training path has
    no quantizer, so jit moves nothing §C5 speaks of; in bf16 XLA's
    fusions keep float32 intermediates an op-by-op run rounds, so bf16
    is compared op by op."""
    if jd not in _GRADS:
        _GRADS[jd] = jax.jit(_value_and_grad(jm, jd))
    return _GRADS[jd]


@pytest.mark.parametrize("dtype,seed", [("float32", 0), ("float32", 1),
                                        ("float32", 3), ("bfloat16", 0)])
def test_loss_and_grads_against_jax(models, dtype, seed):
    jm, tm = models
    jd, td = DTYPES[dtype]
    jp, tp = _params(jm, seed)
    batch = _batch(seed)
    jbatch = jax.tree.map(jnp.asarray, batch)
    if dtype == "float32":
        (jl, jmet), jg = _jit_grad(jm, jd)(jp, jbatch)
    else:
        with jax.disable_jit():
            (jl, jmet), jg = _value_and_grad(jm, jd)(jp, jbatch)
    (tl, tmet), tg = tsteps.make_grad_fn(tm, Ctx(
        plan=default_plan(), quant=False, compute_dtype=td))(
        tp, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert abs(float(tl) - float(jl)) <= (1e-5 if dtype == "float32"
                                          else 2 ** -7) * abs(float(jl))
    _same_metric_keys(tmet, jmet)
    assert float(tmet["aux_loss"]) == float(jmet["aux_loss"]) == 0.0
    jleaves = jax.tree_util.tree_flatten_with_path(jg)[0]
    tleaves = tree_leaves(tg)
    assert len(jleaves) == len(tleaves)
    for (path, a), b in zip(jleaves, tleaves):
        assert tuple(b.shape) == np.asarray(a).shape
        assert not b.requires_grad
        assert _rel(a, b.to(torch.float32).numpy()) <= 2 ** -7, \
            jax.tree_util.keystr(path)
    # the parameters themselves are untouched and need no grad
    assert not any(t.requires_grad for t in tree_leaves(tp))


def test_flash_attention_grads_bit_exact_on_the_same_inputs():
    rng = np.random.default_rng(0)
    b, h, s, dh = 2, 4, 16, 16
    q, k, v, ct = (rng.standard_normal((b, h, s, dh)).astype(np.float32)
                   for _ in range(4))
    pos = np.broadcast_to(np.arange(s, dtype=np.int32)[None], (b, s)).copy()
    for chunk in (5,):          # four chunks: the bf16 sum of q's grad
        def f(q, k, v):
            o = jattn.flash_attention(q, k, v, q_positions=jnp.asarray(pos),
                                      kv_positions=jnp.asarray(pos),
                                      causal=True, chunk=chunk)
            return jnp.sum(o * ct)

        with jax.disable_jit():
            jg = jax.grad(f, argnums=(0, 1, 2))(*map(jnp.asarray,
                                                      (q, k, v)))
        tq, tk, tv = (torch.from_numpy(x.copy()).requires_grad_()
                      for x in (q, k, v))
        o = tattn.flash_attention(tq, tk, tv,
                                  q_positions=torch.from_numpy(pos),
                                  kv_positions=torch.from_numpy(pos),
                                  causal=True, chunk=chunk)
        (o * torch.from_numpy(ct)).sum().backward()
        for a, t in zip(jg, (tq, tk, tv)):
            assert np.asarray(a).tobytes() == t.grad.numpy().tobytes(), chunk


def test_mlp_and_rmsnorm_grads_tight_in_float32():
    rng = np.random.default_rng(1)
    d, f = 64, 128
    w = {n: (rng.standard_normal(shape) * 0.1).astype(np.float32)
         for n, shape in (("up", (d, f)), ("gate", (d, f)),
                          ("down", (f, d)))}
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    x = rng.standard_normal((2, 8, d)).astype(np.float32)
    ct = rng.standard_normal((2, 8, d)).astype(np.float32)

    def jf(w, scale, x):
        h = jnorms.rmsnorm({"scale": scale}, x)
        y, _ = jmlp.mlp({k: {"w": v} for k, v in w.items()}, h,
                        JCtx(quant=False, compute_dtype=jnp.float32))
        return jnp.sum(y * ct)

    with jax.disable_jit():
        jg = jax.grad(jf, argnums=(0, 1, 2))(
            jax.tree.map(jnp.asarray, w), jnp.asarray(scale),
            jnp.asarray(x))
    tw = {k: torch.from_numpy(v.copy()).requires_grad_()
          for k, v in w.items()}
    ts = torch.from_numpy(scale.copy()).requires_grad_()
    tx = torch.from_numpy(x.copy()).requires_grad_()
    h = tnorms.rmsnorm({"scale": ts}, tx)
    y, _ = tmlp.mlp({k: {"w": v} for k, v in tw.items()}, h,
                    Ctx(quant=False, compute_dtype=torch.float32))
    (y * torch.from_numpy(ct)).sum().backward()
    for k in w:
        assert _rel(jg[0][k], tw[k].grad.numpy()) <= 1e-5, k
    assert _rel(jg[1], ts.grad.numpy()) <= 1e-5
    assert _rel(jg[2], tx.grad.numpy()) <= 1e-5


class _JaxWith:
    """``jax`` with ``value_and_grad`` replaced (one module's view)."""

    def __init__(self, **over):
        self.__dict__.update(over)

    def __getattr__(self, name):
        return getattr(jax, name)


@pytest.mark.parametrize("accum,compress,max_norm", [
    (1, False, 1e9), (4, True, 1e9), (2, True, 1.0)])
def test_train_step_composition_against_jax(models, monkeypatch, accum,
                                            compress, max_norm):
    """Both steps take the same microbatch gradients (JAX's, jitted);
    then the port's step equals JAX's ``make_train_step`` run op by op:
    new params, moments, count, step, residuals and metrics; with
    clipping active (max_norm 1) within the norm's float32 ulps."""
    jm, tm = models
    jp, tp = _params(jm, 5)
    batch = _batch(5, b=4)
    grad = _jit_grad(jm, jnp.float32)
    micro = []
    for i in range(accum):
        mb = {k: v.reshape((accum, -1) + v.shape[1:])[i]
              for k, v in batch.items()}
        (l, m), g = jax.device_get(grad(jp, jax.tree.map(jnp.asarray, mb)))
        micro.append((mb["tokens"], ((l, m), g)))

    def lookup(tokens):
        for toks, out in micro:
            if np.array_equal(np.asarray(tokens), toks):
                return out
        raise AssertionError("unknown microbatch")

    def j_value_and_grad(fn, has_aux):
        def run(p, b):
            (l, m), g = lookup(b["tokens"])
            return ((jnp.asarray(l), jax.tree.map(jnp.asarray, m)),
                    jax.tree.map(jnp.asarray, g))
        return run

    def t_grad_fn(model, ctx):
        def run(p, b):
            (l, m), g = lookup(b["tokens"].numpy())
            return ((torch.from_numpy(np.array(l)),
                     {k: torch.from_numpy(np.array(v))
                      for k, v in m.items()}), from_jax(g, device="cpu"))
        return run

    monkeypatch.setattr(jsteps, "jax", _JaxWith(
        value_and_grad=j_value_and_grad))
    monkeypatch.setattr(tsteps, "make_grad_fn", t_grad_fn)
    kw = dict(accum=accum, peak_lr=1e-2, warmup=0, total_steps=10,
              max_grad_norm=max_norm, compress=compress)
    jctx = JCtx(plan=j_plan(), quant=False, compute_dtype=jnp.float32)
    opt = {"m": jax.tree.map(jnp.zeros_like, jp),
           "v": jax.tree.map(jnp.zeros_like, jp),
           "count": jnp.zeros((), jnp.int32)}
    js = {"params": jp, "opt": opt, "step": jnp.zeros((), jnp.int32)}
    if compress:
        from repro.runtime.compression import init_compression
        js["comm"] = init_compression(jp)
    with jax.disable_jit():
        jnew, jmet = jsteps.make_train_step(jm, jctx, **kw)(
            js, jax.tree.map(jnp.asarray, batch))
    ts = {"params": tp, "opt": from_jax(jax.tree.map(np.asarray, opt),
                                        device="cpu"),
          "step": torch.zeros((), dtype=torch.int32)}
    if compress:
        ts["comm"] = from_jax(jax.tree.map(np.asarray, js["comm"]),
                              device="cpu")
    tnew, tmet = tsteps.make_train_step(tm, Ctx(
        plan=default_plan(), quant=False, compute_dtype=torch.float32),
        **kw)(ts, {k: torch.from_numpy(v) for k, v in batch.items()})
    # the port's step got JAX's microbatch metrics, so every key is JAX's
    assert set(tnew) == set(jnew) and set(tmet) == set(jmet)
    assert int(tnew["step"]) == 1 and int(tnew["opt"]["count"]) == 1
    jl = jax.tree.leaves({k: jnew[k] for k in ("params", "opt", "comm")
                          if k in jnew})
    tl = tree_leaves({k: tnew[k] for k in ("params", "opt", "comm")
                      if k in tnew})
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        a = np.asarray(a)
        if max_norm > 1e8:
            assert a.tobytes() == b.numpy().tobytes()
        else:
            # lr 1e-2: a few ulps of a unit Adam step
            np.testing.assert_allclose(b.numpy(), a, rtol=1e-6, atol=1e-7)
    for k in ("loss", "loss_final", "lr", "aux_loss"):
        assert float(tmet[k]) == float(jmet[k]), k
    assert abs(float(tmet["grad_norm"]) - float(jmet["grad_norm"])) <= \
        8 * np.spacing(np.float32(jmet["grad_norm"]))
    if compress:
        assert int(tmet["comm/errors"]) == int(jmet["comm/errors"]) == 0
        assert isinstance(tnew["comm"], CompressionState)


def test_train_steps_run_and_learn(models):
    """Four accumulated, compressed steps from the port's own init:
    finite losses that fall, 0 comm errors, and the caller's state left
    as it was (the loop's recompute re-runs from it)."""
    _, tm = models
    state = tsteps.init_train_state(tm, 0, compress=True, device="cpu")
    before = [t.clone() for t in tree_leaves(state)]
    step = tsteps.make_train_step(tm, Ctx(quant=False,
                                          compute_dtype=torch.float32),
                                  accum=4, peak_lr=1e-2, warmup=0,
                                  total_steps=10, compress=True)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0, b=8).items()}
    losses = []
    s = state
    for _ in range(4):
        s, m = step(s, batch)
        assert int(m["comm/errors"]) == 0
        losses.append(float(m["loss_final"]))
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    for a, b in zip(before, tree_leaves(state)):
        assert torch.equal(a, b)


def test_payload_hook_is_the_transport_seam(models):
    """A byte of the payload flipped between encode and reduction is
    caught in comm/errors."""
    _, tm = models
    state = tsteps.init_train_state(tm, 0, compress=True, device="cpu")

    def hook(payload, st):
        leaf = tree_leaves(payload["q"])[0]
        leaf.view(-1).view(torch.uint8)[3] ^= 1 << 5
        return payload

    step = tsteps.make_train_step(tm, Ctx(quant=False,
                                          compute_dtype=torch.float32),
                                  compress=True, payload_hook=hook)
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    _, m = step(state, batch)
    assert int(m["comm/errors"]) == 1


def test_float_init_tree_matches_jax(models):
    jm, tm = models
    flat = jax.tree_util.tree_flatten_with_path
    for quant in (False, True):
        shapes = jax.eval_shape(lambda: values_of(
            jm.init(jax.random.key(0), quant=quant)))
        want = [(jax.tree_util.keystr(k), v.shape, v.dtype.name)
                for k, v in flat(shapes)[0]]
        mine = tm.init(0, quant=quant, device="cpu")
        got = [(jax.tree_util.keystr(k), tuple(v.shape),
                str(v.dtype).removeprefix("torch.")) for k, v in
               flat(jax.tree.map(lambda t: t, mine))[0]]
        assert got == want
    bf = tm.init(0, dtype=torch.bfloat16, device="cpu")
    assert bf["lm_head"]["w"].dtype == torch.bfloat16


def test_train_state_shapes_and_input_specs_match_jax(models):
    jm, tm = models
    j_lp = jsteps.train_state_lp(jm, compress=True)
    j_shapes = [(v.value.shape, v.value.dtype.name) for v in
                jax.tree.leaves(j_lp, is_leaf=lambda x: hasattr(x, "axes"))]
    t_state = tsteps.train_state_shapes(tm, compress=True)
    t_shapes = [(tuple(t.shape), str(t.dtype).removeprefix("torch."))
                for t in tree_leaves(t_state)]
    assert t_shapes == j_shapes
    assert all(t.device.type == "meta" for t in tree_leaves(t_state))
    assert tsteps.state_bytes(t_state) == sum(
        int(np.prod(s)) * 4 for s, _ in t_shapes)
    for kind in ("train", "prefill", "decode"):
        jspec = jm.input_specs(JShape("t", kind, 16, 4))
        tspec = tm.input_specs(ShapeConfig("t", kind, 16, 4))
        assert set(jspec) == set(tspec)
        for k in jspec:
            assert tuple(tspec[k].shape) == jspec[k].value.shape
            assert tspec[k].dtype == torch.int32


@pytest.mark.parametrize("arch", ["granite-moe-3b-a800m", "rwkv6-1.6b"])
def test_moe_and_ssm_train(arch):
    """The MoE and the float RWKV train on the port's own weights: a
    finite loss (granite's with its load-balance loss), every leaf's
    gradient finite; RWKV keeps its int8 serving form under ``quant``."""
    m = build_model(reduce_cfg(get_arch(arch)))
    batch = {k: torch.from_numpy(v) for k, v in _batch(0).items()}
    params = m.init(0, device="cpu")
    (loss, metrics), grads = tsteps.make_grad_fn(m, Ctx(
        quant=False, compute_dtype=torch.float32))(params, batch)
    assert np.isfinite(float(loss))
    assert (float(metrics["aux_loss"]) > 0) == (m.cfg.family == "moe")
    assert all(torch.isfinite(g).all() for g in tree_leaves(grads))
    if m.cfg.family == "ssm":
        assert params["embed"]["table"].dtype == torch.float32
        q = m.init(0, quant=True, device="cpu")
        assert q["embed"]["table"].dtype == torch.int8


def test_whole_train_state_converts_from_jax(models):
    jm, tm = models
    js = jax.device_get(jsteps.init_train_state(jm, jax.random.key(0),
                                                compress=True))
    ts = from_jax(js, device="cpu")
    assert isinstance(ts["comm"], CompressionState)
    assert ts["step"].dtype == torch.int32 and ts["step"].shape == ()
    step = tsteps.make_train_step(tm, Ctx(quant=False,
                                          compute_dtype=torch.float32),
                                  compress=True)
    new, m = step(ts, {k: torch.from_numpy(v)
                       for k, v in _batch(0).items()})
    assert int(new["step"]) == 1 and int(m["comm/errors"]) == 0


def test_cli_trains_the_smoke_model_on_the_cpu(tmp_path, caplog):
    from repro_torch.launch import train
    caplog.set_level("INFO")
    assert train.main(["--arch", "llama3.2-1b", "--smoke", "--steps", "20",
                       "--compress", "--device", "cpu", "--seq-len", "32",
                       "--batch", "4", "--ckpt-dir",
                       str(tmp_path / "ck")]) == 0
    done = [r.getMessage() for r in caplog.records
            if r.getMessage().startswith("done:")]
    assert done and "'comm/errors': 0.0" in done[0]
    assert "'faulty_steps': 0" in done[0]
    assert "step 20 loss=" in caplog.text
    assert (tmp_path / "ck" / "step_000000020" / "COMMIT").exists()


@pytest.mark.parametrize("argv,refusal", [
    (["--mesh", "single"], "cannot reshape array of size 1 into shape "
                           "(16,16)"),
    (["--mesh-shape", "2,2", "--device-count", "4"], "mesh=(2, 2)"),
    (["--device-count", "4"], "mesh=(4, 1)")])
def test_cli_refuses_the_mesh_flags(capfd, tmp_path, argv, refusal):
    """The production mesh on a world smaller than 256 ranks exits with
    2, JAX's error on a host, naming ROADMAP A8.4; ``--mesh-shape 2,2
    --device-count 4`` trains on a (2, 2) mesh (tensor parallelism over
    ``model``) and ``--device-count 4`` on a (4, 1) data mesh, of gloo
    ranks."""
    from repro_torch.launch import train
    if refusal.startswith("mesh="):
        assert train.main(["--smoke", "--device", "cpu", "--steps", "2",
                           "--seq-len", "16", "--batch", "8", "--ckpt-dir",
                           str(tmp_path)] + argv) == 0
        err = capfd.readouterr().err
        assert refusal in err and "'faulty_steps': 0" in err
        return
    with pytest.raises(SystemExit) as ei:
        train.main(["--smoke", "--device", "cpu"] + argv)
    assert ei.value.code == 2
    err = capfd.readouterr().err
    assert refusal in err and "A8.4" in err


def test_cli_without_a_card_raises(monkeypatch, tmp_path):
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--smoke", "--steps", "1", "--ckpt-dir",
                    str(tmp_path)])


def test_accumulation_must_divide_the_batch(tmp_path):
    from repro_torch.launch import train
    with pytest.raises(SystemExit, match="multiple"):
        train.main(["--smoke", "--device", "cpu", "--accum", "3",
                    "--batch", "4", "--ckpt-dir", str(tmp_path)])
    assert dataclasses.replace(T_CFG, train_accum=3).train_accum == 3
