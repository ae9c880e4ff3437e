"""Training granite-moe-3b-a800m's reduced model (the MoE with its
load-balance loss) in the port against the JAX package, on the CPU.

* ``Model.loss`` and every gradient leaf against
  ``jax.value_and_grad(Model.loss)`` on JAX's weights: the loss within
  1e-5 (f32) or 2^-7 (bf16) of JAX's, each leaf within 2^-7 of its
  largest magnitude in float32 compute (the bf16 attention's
  cotangents, ROADMAP §C10, and the dispatch's bf16 rows) and 2^-6 in
  bf16 compute (§C13), the load-balance loss within 1e-6.
* The routing under grad, layer by layer: ``topk_stable``'s experts, the
  slots and the capacity drops equal JAX's exactly, in both dispatches
  and at a capacity that drops choices, before the expert, router and
  input gradients are compared (2^-7).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.layers import moe as jmoe  # noqa: E402
from repro.layers.common import Ctx as JCtx  # noqa: E402
from repro.sharding import values_of  # noqa: E402
from repro_torch.layers import moe as tmoe  # noqa: E402
from repro_torch.layers.common import Ctx  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402

from torch_family_parity import check_loss_and_grads  # noqa: E402

ARCH = "granite-moe-3b-a800m"
D, F, E, K, G = 64, 128, 4, 2, 16


@pytest.mark.parametrize("dtype,seed", [("float32", 0), ("float32", 1),
                                        ("bfloat16", 0), ("bfloat16", 1)])
def test_loss_and_grads_against_jax(dtype, seed):
    (_, jmet), (_, tmet) = check_loss_and_grads(ARCH, dtype, seed)
    assert jmet["aux_loss"] > 0
    assert abs(tmet["aux_loss"] - jmet["aux_loss"]) <= \
        1e-6 * jmet["aux_loss"]


def _layer(seed):
    p = values_of(jax.jit(lambda k: jmoe.init_moe(k, D, F, E))(
        jax.random.key(seed)))
    p = jax.tree.map(np.asarray, p)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((2, G, D)).astype(np.float32)
    ct = rng.standard_normal((2, G, D)).astype(np.float32)
    return p, x, ct


@pytest.mark.parametrize("gather", [False, True])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_routing_slots_drops_and_grads_against_jax(gather, capacity_factor):
    p, x, ct = _layer(3)
    groups = x.reshape(-1, G, D)
    capacity = min(max(int(G * K * capacity_factor / E), 4), G)
    # the routing of both packages, the port's under grad
    jprobs, jvals, jidx = jmoe._route(jnp.asarray(groups),
                                      jnp.asarray(p["router"]["w"]), K)
    jslot = np.asarray(jmoe._slot_assignment(jidx, E, capacity))
    jaux = float(jmoe._aux_loss(jprobs, jidx, E))
    tx = torch.from_numpy(groups.copy()).requires_grad_()
    tw = torch.from_numpy(p["router"]["w"].copy()).requires_grad_()
    probs, vals, idx = tmoe._route(tx, tw, K)
    slot = tmoe.slot_assignment(idx, E, capacity)
    aux = tmoe._aux_loss(probs, idx, E)
    assert vals.requires_grad and aux.requires_grad
    assert np.array_equal(idx.numpy(), np.asarray(jidx))
    assert np.array_equal(slot.numpy(), jslot)
    drops = jslot == E * capacity
    assert np.array_equal(slot.numpy() == E * capacity, drops)
    if capacity_factor < 1:
        assert drops.sum() > 0          # the capacity bites
    np.testing.assert_allclose(vals.detach().numpy(), np.asarray(jvals),
                               rtol=1e-6, atol=1e-7)
    assert abs(float(aux.detach()) - jaux) <= 1e-6 * jaux

    # the layer's output and its gradients, float experts
    def jf(p, x):
        y, aux, _ = jmoe.moe_ffn(p, x, JCtx(quant=False, moe_gather=gather,
                                            compute_dtype=jnp.float32),
                                 n_experts=E, top_k=K,
                                 capacity_factor=capacity_factor,
                                 group_size=G)
        return jnp.sum(y.astype(jnp.float32) * ct) + aux

    jg = jax.grad(jf, argnums=(0, 1))(jax.tree.map(jnp.asarray, p),
                                      jnp.asarray(x))
    tp = from_jax(p, "cpu")
    for leaf in (tp["router"]["w"], tp["gate"]["w"], tp["up"]["w"],
                 tp["down"]["w"]):
        leaf.requires_grad_()
    tx = torch.from_numpy(x.copy()).requires_grad_()
    y, aux, _ = tmoe.moe_ffn(tp, tx, Ctx(quant=False, moe_gather=gather,
                                         compute_dtype=torch.float32),
                             n_experts=E, top_k=K,
                             capacity_factor=capacity_factor, group_size=G)
    ((y.float() * torch.from_numpy(ct)).sum() + aux).backward()
    pairs = [(jg[0]["router"]["w"], tp["router"]["w"].grad)] + [
        (jg[0][n]["w"], tp[n]["w"].grad) for n in ("gate", "up", "down")] + [
        (jg[1], tx.grad)]
    for a, b in pairs:
        a = np.asarray(a)
        assert b.shape == a.shape
        err = float(np.abs(a - b.numpy()).max() / np.abs(a).max())
        assert err <= 2 ** -7, err


def test_seq_groups_grads_equal_one_block():
    """``moe_seq_groups`` runs the groups one at a time (JAX's rematted
    scan): the same output and gradients as the one block, within
    float32 round-off (1e-6 of each one's largest magnitude: the groups'
    products sum in another order)."""
    p, x, ct = _layer(4)
    x = np.concatenate([x, x[::-1]], 1)       # two groups a row
    ct = np.concatenate([ct, ct], 1)
    out = []
    for seq_groups in (False, True):
        tp = from_jax(p, "cpu")
        tp["gate"]["w"].requires_grad_()
        tx = torch.from_numpy(x.copy()).requires_grad_()
        y, aux, _ = tmoe.moe_ffn(tp, tx, Ctx(quant=False,
                                             moe_seq_groups=seq_groups,
                                             compute_dtype=torch.float32),
                                 n_experts=E, top_k=K, group_size=G)
        ((y.float() * torch.from_numpy(ct)).sum() + aux).backward()
        out.append((y.detach(), tx.grad, tp["gate"]["w"].grad))
    for a, b in zip(*out):
        assert float((a - b).abs().max()) <= 1e-6 * float(a.abs().max())
