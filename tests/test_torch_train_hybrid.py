"""Training hymba-1.5b's reduced model (the hybrid: attention beside a
Mamba branch, 4 meta tokens) in the port against the JAX package, on
the CPU.

* ``Model.loss`` (the labels padded with ``IGNORE`` over the meta
  tokens) and every gradient leaf against
  ``jax.value_and_grad(Model.loss)`` on JAX's weights: the loss within
  1e-5 (f32) or 2^-7 (bf16), each leaf within 2^-7 of its largest
  magnitude in float32 compute (the bf16 attention's cotangents reach
  every leaf, the SSM's too: ROADMAP §C10) and 2^-6 in bf16 compute
  (§C13: XLA sums the SSM input's bf16 rows in bf16); with ``ssm_chunk`` 0 (the train CLI's) and 4 (a
  chunk that divides the 20 positions: JAX's two-level rematted scan,
  the port's chunks under ``torch.utils.checkpoint``).
* The Mamba branch alone, float32, no attention: its leaves' gradients
  and the input's within 1e-5 of JAX's ``lax.scan`` (the scan's float32
  sums run in another order), with ``ssm_chunk`` 0 and 4; the chunked
  scan equals the plain one.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers import mamba as j_mam  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.layers import mamba as t_mam  # noqa: E402
from repro_torch.layers.common import Ctx  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402

from torch_family_parity import check_loss_and_grads  # noqa: E402

ARCH = "hymba-1.5b"
D, DI, N = 64, 128, 4


@pytest.mark.parametrize("dtype,seed,chunk", [
    ("float32", 0, 0), ("float32", 1, 0), ("bfloat16", 0, 0),
    ("bfloat16", 1, 0), ("float32", 0, 4)])
def test_loss_and_grads_against_jax(dtype, seed, chunk):
    (_, jmet), (_, tmet) = check_loss_and_grads(ARCH, dtype, seed,
                                                ssm_chunk=chunk)
    assert jmet["aux_loss"] == tmet["aux_loss"] == 0.0


def _mamba_case(seed, s=16):
    p = jax.tree.map(np.asarray, values_of(jax.jit(
        lambda k: j_mam.init_mamba(k, D, DI, N))(jax.random.key(seed))))
    rng = np.random.default_rng(seed)
    # the decay's and the skip's leaves away from their ones-init
    p["a_log"] = rng.uniform(-1, 1, p["a_log"].shape).astype(np.float32)
    p["d_skip"] = rng.standard_normal(p["d_skip"].shape).astype(np.float32)
    x = rng.standard_normal((2, s, D)).astype(np.float32)
    ct = rng.standard_normal((2, s, D)).astype(np.float32)
    return p, x, ct


def _port_grads(p, x, ct, chunk):
    tp = from_jax(p, "cpu")
    leaves = [t for lin in tp.values()
              for t in (lin.values() if isinstance(lin, dict) else [lin])]
    for t in leaves:
        t.requires_grad_()
    tx = torch.from_numpy(x.copy()).requires_grad_()
    y, _, _ = t_mam.mamba(tp, tx, t_mam.init_mamba_cache(
        2, DI, N, device="cpu"), Ctx(quant=False, ssm_chunk=chunk,
                                      compute_dtype=torch.float32),
        d_inner=DI, n_state=N)
    (y.float() * torch.from_numpy(ct)).sum().backward()
    return y.detach(), tp, tx.grad


@pytest.mark.parametrize("chunk", [0, 4])
def test_mamba_grads_against_jax_in_float32(chunk):
    p, x, ct = _mamba_case(6)

    def jf(p, x):
        cache = jax.tree.map(lambda t: t.value if hasattr(t, "value") else t,
                             j_mam.init_mamba_cache(2, DI, N),
                             is_leaf=lambda t: hasattr(t, "value"))
        y, _, _ = j_mam.mamba(p, x, cache, JCtx(
            quant=False, ssm_chunk=chunk, compute_dtype=jnp.float32),
            d_inner=DI, n_state=N)
        return jnp.sum(y.astype(jnp.float32) * ct)

    jg = jax.grad(jf, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x))
    _, tp, gx = _port_grads(p, x, ct, chunk)
    flat = jax.tree_util.tree_flatten_with_path(jg[0])[0]
    for path, a in flat:
        node = tp
        for k in path:
            node = node[k.key]
        a = np.asarray(a)
        err = float(np.abs(a - node.grad.numpy()).max() / np.abs(a).max())
        assert err <= 1e-5, (jax.tree_util.keystr(path), err)
    a = np.asarray(jg[1])
    assert float(np.abs(a - gx.numpy()).max() / np.abs(a).max()) <= 1e-5


def test_chunked_scan_equals_the_plain_scan():
    """``ssm_chunk`` changes memory, not numbers: the chunked scan's
    output and gradients equal the plain scan's within float32 round-off
    (1e-6 of each one's largest magnitude)."""
    p, x, ct = _mamba_case(7)
    y0, p0, g0 = _port_grads(p, x, ct, 0)
    y4, p4, g4 = _port_grads(p, x, ct, 4)
    pairs = [(y0, y4), (g0, g4)] + [
        (p0[k]["w"].grad, p4[k]["w"].grad)
        for k in ("in_proj", "x_proj", "out_proj", "dt_proj")] + [
        (p0[k].grad, p4[k].grad) for k in ("conv_w", "a_log", "d_skip")]
    for a, b in pairs:
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())
