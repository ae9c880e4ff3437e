"""Training the float RWKV6 (rwkv6-1.6b reduced) in the port against the
JAX package, on the CPU.

* ``Model.loss`` and every gradient leaf against
  ``jax.value_and_grad(Model.loss)`` on JAX's weights: RWKV has no
  attention, so in float32 every leaf, the decay LoRA's (its
  ``exp(-exp(·))`` clamped at ``LOG_W_MIN``) among them, is held to 1e-5
  of its largest magnitude and the loss to 1e-5; in bf16 compute 2^-6
  (§C13) and the loss 2^-7.
  Through the per-token recurrence (``wkv_chunk`` 0, the train CLI's)
  and the chunked form at ``wkv_chunk`` 16 (float32 operands: 1e-5;
  bf16 operands, ``wkv_mm_bf16``: 2^-7, as a bf16 rounding of an
  operand moves with an f32 ulp upstream, but for the decay's leaves,
  which rounding decides in both packages, ROADMAP §C14).
* The WKV forms alone, forward and gradients, against JAX's
  ``wkv_recurrent`` and its XLA ``wkv_chunked`` on the same inputs.
* The float model's prefill and greedy decodes against JAX's.
* K4's wrapper refuses inputs that require grad (it has no backward).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers import rwkv6 as j_rk  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.models import base as j_base  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.layers import rwkv6 as t_rk  # noqa: E402
from repro_torch.layers.common import Ctx  # noqa: E402
from repro_torch.models import base as t_base  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402

from torch_family_parity import (check_loss_and_grads,  # noqa: E402
                                 jax_value_and_grad, np_tree,
                                 port_value_and_grad, scaled_err,
                                 train_batch, train_cfgs, train_weights)

ARCH = "rwkv6-1.6b"


@pytest.mark.parametrize("dtype,seed", [("float32", 0), ("float32", 1),
                                        ("bfloat16", 0), ("bfloat16", 1)])
def test_loss_and_grads_against_jax(dtype, seed):
    (_, jmet), (_, tmet) = check_loss_and_grads(ARCH, dtype, seed)
    assert jmet["aux_loss"] == tmet["aux_loss"] == 0.0


def test_chunked_loss_and_grads_against_jax():
    # the reduced batch's 16 tokens are one chunk of 16
    check_loss_and_grads(ARCH, "float32", 0, tol=1e-5, wkv_chunk=16)


DECAY = ("layers.tm.w0", "layers.tm.w_lora_a", "layers.tm.w_lora_b")


@pytest.mark.parametrize("seed", [0, 1])
def test_chunked_bf16_operands_against_jax(seed):
    """``wkv_mm_bf16``: every leaf but the decay's within 2^-7 of JAX's.
    The decay's gradient is a difference of near-equal terms through the
    e^{±la} factors, each operand rounded to bf16, so rounding decides it
    in both packages (ROADMAP §C14): the port's decay leaves must be no
    farther from JAX's than JAX's own are from its float32-operand
    gradient."""
    cfg = train_cfgs(ARCH)[1]
    w, batch = train_weights(ARCH, seed), train_batch(cfg, seed)
    kw = dict(wkv_chunk=16, wkv_mm_bf16=True)
    jl, _, jg = jax_value_and_grad(ARCH, "float32", w, batch, **kw)
    tl, _, tg = port_value_and_grad(ARCH, "float32", w, batch, **kw)
    _, _, fg = jax_value_and_grad(ARCH, "float32", w, batch, wkv_chunk=16)
    assert abs(tl - jl) <= 1e-5 * abs(jl)
    f = dict(fg)
    for (path, a), (_, b) in zip(jg, tg):
        scale = float(np.abs(f[path]).max())
        err = float(np.abs(a - b).max()) / scale
        if path in DECAY:
            jax_own = float(np.abs(a - f[path]).max()) / scale
            assert err <= jax_own, (path, err, jax_own)
        else:
            assert err <= 2 ** -7, (path, err)


def _wkv_inputs(seed, b=2, s=32, h=2, dh=8):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, dh)).astype(np.float32)
               for _ in range(3))
    # log decays across the clamp: some at LOG_W_MIN, some near 0
    lw = np.clip(-np.exp(rng.uniform(-4, 2.5, (b, s, h, dh))),
                 j_rk.LOG_W_MIN, 0).astype(np.float32)
    u = rng.standard_normal((h, dh)).astype(np.float32)
    s0 = (0.3 * rng.standard_normal((b, h, dh, dh))).astype(np.float32)
    ct_y = rng.standard_normal((b, s, h, dh)).astype(np.float32)
    ct_s = rng.standard_normal((b, h, dh, dh)).astype(np.float32)
    return (r, k, v, lw, u, s0), (ct_y, ct_s)


@pytest.mark.parametrize("form,tol", [("recurrent", 1e-5),
                                      ("chunked", 1e-5),
                                      ("chunked_bf16", 2.0**-7)])
def test_wkv_forms_and_grads_against_jax(form, tol):
    args, (ct_y, ct_s) = _wkv_inputs(7)
    if form == "recurrent":
        jfn, tfn = j_rk.wkv_recurrent, t_rk.wkv_recurrent
    else:
        mm = form == "chunked_bf16"

        def jfn(*a):
            return j_rk.wkv_chunked(*a, chunk=16, mm_dtype=(
                jnp.bfloat16 if mm else jnp.float32))

        def tfn(*a):
            return kref.wkv_chunked_ref(*a, chunk=16, mm_dtype=(
                torch.bfloat16 if mm else torch.float32))

    def jloss(*a):
        y, st = jfn(*a)
        return jnp.sum(y * ct_y) + jnp.sum(st * ct_s), (y, st)

    jg, (jy, js) = jax.grad(jloss, argnums=tuple(range(6)), has_aux=True)(
        *map(jnp.asarray, args))
    targs = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
    ty, ts = tfn(*targs)
    ((ty * torch.from_numpy(ct_y)).sum()
     + (ts * torch.from_numpy(ct_s)).sum()).backward()
    assert scaled_err(ty.detach().numpy(), jy) <= tol
    assert scaled_err(ts.detach().numpy(), js) <= tol
    for name, a, t in zip(("r", "k", "v", "lw", "u", "state"), jg, targs):
        assert scaled_err(t.grad.numpy(), a) <= tol, name


def test_chunked_form_equals_the_recurrence():
    """The chunked form is an exact reformulation: within float32
    round-off of the recurrence, forward and gradients."""
    args, (ct_y, ct_s) = _wkv_inputs(8)
    out = []
    for fn in (t_rk.wkv_recurrent, kref.wkv_chunked_ref):
        targs = [torch.from_numpy(a.copy()).requires_grad_() for a in args]
        y, st = fn(*targs)
        ((y * torch.from_numpy(ct_y)).sum()
         + (st * torch.from_numpy(ct_s)).sum()).backward()
        out.append([y.detach(), st.detach()] + [t.grad for t in targs])
    for a, b in zip(*out):
        assert float((a - b).abs().max()) <= 1e-4 * float(a.abs().max())


def test_k4_wrapper_refuses_grad():
    args, _ = _wkv_inputs(9, s=16)
    t = [torch.from_numpy(a.copy()) for a in args]
    with pytest.raises(RuntimeError, match="no backward"):
        kops.wkv_chunked(*t[:3], t[3].requires_grad_(), *t[4:], chunk=16)
    with torch.no_grad():       # the serving prefill's call
        y, st = kops.wkv_chunked(*t, chunk=16)
    want, _ = kref.wkv_chunked_ref(*(x.detach() for x in t), chunk=16)
    assert float((y - want).abs().max()) <= 1e-5 * float(want.abs().max())
    # and the float layer never hands it grad: timemix takes the
    # differentiable plain form by name
    kref.wkv_chunked_ref(*(x.detach().requires_grad_() for x in t),
                         chunk=16)


@pytest.mark.parametrize("chunk", [0, 16])
def test_float_prefill_and_decode_against_jax(chunk):
    """The float RWKV served through ``Model``: a 16-token prefill (the
    chunked form at ``wkv_chunk`` 16) and 3 greedy decodes, logits and
    recurrent state against JAX's in float32 (1e-5 of their scale)."""
    j_cfg, t_cfg = train_cfgs(ARCH)
    w = train_weights(ARCH, 2)
    jm, tm = j_base.Model(j_cfg), t_base.Model(t_cfg)
    jctx = JCtx(quant=False, compute_dtype=jnp.float32, wkv_chunk=chunk)
    tctx = Ctx(quant=False, compute_dtype=torch.float32, wkv_chunk=chunk)
    toks = np.random.default_rng(2).integers(
        0, t_cfg.vocab, (2, 16)).astype(np.int32)
    jp, tp = jax.tree.map(jnp.asarray, w), from_jax(w, "cpu")
    jl, jc, _ = jax.jit(lambda p, t: jm.prefill(p, {"tokens": t}, jctx,
                                                32))(jp, jnp.asarray(toks))
    tl, tc, _ = tm.prefill(tp, {"tokens": torch.from_numpy(toks)}, tctx, 32)
    pos = np.full((2,), 16, np.int32)
    jdec = jax.jit(lambda p, c, t, q: jm.decode(p, c, t, q, jctx))
    for _ in range(3):
        assert scaled_err(tl.numpy(), jl) <= 1e-5
        for k in ("S", "x_tm", "x_cm"):
            assert scaled_err(tc[k].numpy(), np_tree(jc)[k]) <= 1e-5, k
        nxt = np.argmax(np.asarray(jl)[:, :t_cfg.vocab], -1).astype(np.int32)
        jl, jc, _ = jdec(jp, jc, jnp.asarray(nxt), jnp.asarray(pos))
        tl, tc, _ = tm.decode(tp, tc, torch.from_numpy(nxt),
                              torch.from_numpy(pos), tctx)
        pos = pos + 1
    zero = tm.init_cache(2, 32, device="cpu")
    want = np_tree(jm.init_cache(2, 32))
    assert {k: tuple(v.shape) for k, v in zero.items()} == \
        {k: v.shape for k, v in want.items()}


def test_float_init_tree_matches_jax():
    j_cfg, t_cfg = train_cfgs(ARCH)
    jm, tm = j_base.Model(j_cfg), t_base.Model(t_cfg)
    flat = jax.tree_util.tree_flatten_with_path
    for quant in (False, True):
        shapes = jax.eval_shape(lambda: values_of(jm.init(
            jax.random.key(0), quant=quant)))
        want = [(jax.tree_util.keystr(k), v.shape, v.dtype.name)
                for k, v in flat(shapes)[0]]
        mine = tm.init(0, quant=quant, device="cpu")
        got = [(jax.tree_util.keystr(k), tuple(v.shape),
                str(v.dtype).removeprefix("torch."))
               for k, v in flat(jax.tree.map(lambda t: t, mine))[0]]
        assert got == want
    bf = tm.init(0, dtype=torch.bfloat16, device="cpu")
    assert bf["layers"]["tm"]["w_lora_a"].dtype == torch.bfloat16
    lora = tm.init(3, device="cpu")["layers"]["tm"]["w_lora_a"]
    assert 0.015 < float(lora.std()) < 0.025          # param() scale 0.02


def test_scan_graph_cache_is_the_steps_own():
    """The CUDA graphs the training scans replay belong to the step that
    made them: ``make_train_step`` gives its ``Ctx`` a cache of its own
    (the caller's stays None), the cache is no setting (contexts compare
    equal and hash alike with and without one), and on the CPU the scan
    runs its loop eagerly with or without it: the same values."""
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.launch import steps
    from repro_torch.layers import scan
    seen = []
    real = steps.make_grad_fn

    def spy(model, ctx):
        seen.append(ctx.scan_graphs)
        return real(model, ctx)

    ctx = Ctx(quant=False, compute_dtype=torch.float32)
    model = t_base.Model(reduce_cfg(get_arch(ARCH)), max_pos=64)
    try:
        steps.make_grad_fn = spy
        steps.make_train_step(model, ctx)
        steps.make_train_step(model, ctx)
    finally:
        steps.make_grad_fn = real
    assert ctx.scan_graphs is None
    assert all(isinstance(g, scan.ScanGraphs) for g in seen)
    assert seen[0] is not seen[1]
    with_cache = ctx.replace(scan_graphs=seen[0])
    assert with_cache == ctx and hash(with_cache) == hash(ctx)
    rng = np.random.default_rng(4)
    a, b = (torch.from_numpy(rng.uniform(0.2, 1.0, (2, 9, 3)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal((2, 9, 3)).astype(
            np.float32)))
    h0 = torch.zeros(2, 3)
    out = [scan.linear_scan(a, b, h0, graphs=g) for g in (None, seen[0])]
    assert torch.equal(out[0], out[1])
    assert not seen[0]._graphs          # nothing captured on the CPU
