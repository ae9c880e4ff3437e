"""Training whisper-large-v3's reduced model (the encoder-decoder) in the
port against the JAX package, on the CPU.

* ``Model.loss`` (frames through the encoder, the teacher-forced decoder
  with its cross-attention) and every gradient leaf against
  ``jax.value_and_grad(Model.loss)`` on JAX's weights: the loss within
  1e-5 (f32) or 2^-7 (bf16); each leaf within 2^-7 of its largest
  magnitude in float32 (the bf16 attention's cotangents, ROADMAP §C10),
  2^-5 in bf16 compute (§C13: XLA sums the bias gradients' bf16 rows in
  bf16).  A key projection's bias has no gradient in exact arithmetic:
  its round-off is held against the ``wk.w`` leaf's scale.
* The cross-attention alone: its leaves' gradients and the memory's
  (the encoder's output) within 2^-7, float32.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers import attention as j_att  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.layers import attention as t_att  # noqa: E402
from repro_torch.layers.common import Ctx  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402

from torch_family_parity import check_loss_and_grads  # noqa: E402

ARCH = "whisper-large-v3"


@pytest.mark.parametrize("dtype,seed", [("float32", 0), ("float32", 1),
                                        ("bfloat16", 0), ("bfloat16", 1)])
def test_loss_and_grads_against_jax(dtype, seed):
    (_, jmet), (_, tmet) = check_loss_and_grads(ARCH, dtype, seed)
    assert jmet["aux_loss"] == tmet["aux_loss"] == 0.0


def test_cross_attention_grads_against_jax():
    d, h, dh, s, t = 64, 4, 16, 8, 12
    p = jax.tree.map(np.asarray, values_of(jax.jit(
        lambda k: j_att.init_attention(k, d, h, h, dh, bias=True))(
            jax.random.key(5))))
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, s, d)).astype(np.float32)
    mem = rng.standard_normal((2, t, d)).astype(np.float32)
    ct = rng.standard_normal((2, s, d)).astype(np.float32)
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (2, s)).copy()
    mpos = np.broadcast_to(np.arange(t, dtype=np.int32), (2, t)).copy()
    kw = dict(n_heads=h, n_kv=h, head_dim=dh, use_rope=False, causal=False,
              chunk=8)

    def jf(p, x, mem):
        y, _ = j_att.attention(p, x, JCtx(quant=False,
                                          compute_dtype=jnp.float32),
                               positions=jnp.asarray(pos), x_kv=mem,
                               kv_positions=jnp.asarray(mpos), **kw)
        return jnp.sum(y.astype(jnp.float32) * ct)

    jg = jax.grad(jf, argnums=(0, 1, 2))(jax.tree.map(jnp.asarray, p),
                                         jnp.asarray(x), jnp.asarray(mem))
    tp = from_jax(p, "cpu")
    for lin in tp.values():
        for leaf in lin.values():
            leaf.requires_grad_()
    tx = torch.from_numpy(x.copy()).requires_grad_()
    tmem = torch.from_numpy(mem.copy()).requires_grad_()
    y, _ = t_att.attention(tp, tx, Ctx(quant=False,
                                       compute_dtype=torch.float32),
                           positions=torch.from_numpy(pos), x_kv=tmem,
                           kv_positions=torch.from_numpy(mpos), **kw)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    pairs = [(f"{n}.{k}", jg[0][n][k], tp[n][k].grad, jg[0][n]["w"])
             for n in tp for k in tp[n]]
    pairs += [("x", jg[1], tx.grad, jg[1]), ("memory", jg[2], tmem.grad,
                                              jg[2])]
    for name, a, b, ref in pairs:
        scale = np.abs(np.asarray(ref if name.endswith("wk.b") else a)).max()
        err = float(np.abs(np.asarray(a) - b.numpy()).max() / scale)
        assert err <= 2 ** -7, (name, err)
