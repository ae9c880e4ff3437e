"""The port's checksummed int8 KV cache and tree checksums against the
JAX package on the same numpy inputs (``repro.core.abft_kvcache``,
``repro.core.checksum``).

Integers and the affine parameters are held bit-exact to the JAX
functions run eagerly.  Under ``jax.jit`` XLA folds the ``span / 255``
division into a multiply by the float32 reciprocal, so the jitted JAX
function parts from its own eager run by one ulp of ``alpha`` (and so of
``beta``) in most rows; the port computes the IEEE quotient, as the eager
run does (ROADMAP §C5; :func:`test_jit_folds_the_division`).  The
attention arithmetic (float32 sums in other orders) is held within 1e-5
of the output scale.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.core import abft_kvcache as jkv  # noqa: E402
from repro.core import checksum as jck  # noqa: E402
from repro.protect import protected_call as j_protected_call  # noqa: E402
from repro.protect.plan import ProtectionPlan as JPlan  # noqa: E402
from repro_torch.core import abft_kvcache as tkv  # noqa: E402
from repro_torch.core import checksum as tck  # noqa: E402
from repro_torch.protect import ProtectionPlan, protected_call  # noqa: E402
from repro_torch.protect.ops import KV_CACHE  # noqa: E402

#: float32 attention sums in another order than XLA's
_ATTN_TOL = 1e-5


def _rows(seed, shape, pad_from=None):
    """Random rows at a random scale; rows from ``pad_from`` on are the
    zero rows a prefill pads its cache with."""
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(shape) * 10 ** rng.uniform(-3, 2)).astype(
        np.float32)
    if pad_from is not None:
        x[..., pad_from:, :] = 0.0
    return x


def _equal(t: tkv.QuantKV, j: jkv.QuantKV):
    for f in tkv.QuantKV._fields:
        got, want = getattr(t, f).numpy(), np.asarray(getattr(j, f))
        assert got.dtype == want.dtype, f
        np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("shape,pad_from", [
    ((2, 2, 128, 64), None), ((1, 8, 104, 64), 64), ((4, 2, 16, 16), 5)])
def test_quantize_kv_rows_is_the_jax_function(shape, pad_from):
    for seed in range(4):
        x = _rows(seed, shape, pad_from)
        t, j = tkv.quantize_kv_rows(torch.from_numpy(x)), \
            jkv.quantize_kv_rows(jnp.asarray(x))
        _equal(t, j)
        np.testing.assert_array_equal(
            tkv.dequantize_kv(t, torch.float32).numpy(),
            np.asarray(jkv.dequantize_kv(j, jnp.float32)))
    if pad_from is not None:
        # a zero row takes the 1e-12 span clamp: code -128, rowsum -128 dh
        assert bool((t.q[..., pad_from:, :] == -128).all())
        assert bool((t.rowsum[..., pad_from:] == -128 * shape[-1]).all())


def test_jit_folds_the_division():
    """The counts ROADMAP §C5 records: seeds 0-19 at three shapes (29440
    rows), the jitted JAX function against its eager run."""
    rows = alpha_differ = beta_differ = q_differ = 0
    for seed in range(20):
        for shape in ((2, 2, 128, 64), (1, 8, 104, 64), (4, 2, 16, 16)):
            x = _rows(seed, shape)
            e = jkv.quantize_kv_rows(jnp.asarray(x))
            j = jax.jit(jkv.quantize_kv_rows)(jnp.asarray(x))
            ea, ja = np.asarray(e.alpha), np.asarray(j.alpha)
            span = np.maximum(x.max(-1) - x.min(-1), np.float32(1e-12))
            # the jitted alpha is the multiply by the f32 reciprocal ...
            np.testing.assert_array_equal(
                ja, (span * np.float32(1 / 255)).astype(np.float32))
            # ... one ulp at most from the IEEE quotient, which the port
            # computes as the eager run does
            assert np.abs(ea.view(np.int32).astype(np.int64)
                          - ja.view(np.int32)).max() <= 1
            _equal(tkv.quantize_kv_rows(torch.from_numpy(x)), e)
            rows += ea.size
            alpha_differ += int((ea != ja).sum())
            beta_differ += int((np.asarray(e.beta) != np.asarray(j.beta))
                               .sum())
            q_differ += int((np.asarray(e.q) != np.asarray(j.q)).sum())
    print(f"rows {rows}: alpha differs in {alpha_differ}, beta in "
          f"{beta_differ}, q in {q_differ} elements")
    assert rows == 29440 and alpha_differ > 0 and q_differ < 100


def test_verify_kv_flags_a_flipped_byte_and_ignores_rows_past_pos():
    x = _rows(7, (2, 2, 32, 16))
    kv = tkv.quantize_kv_rows(torch.from_numpy(x))
    _, err = tkv.verify_kv(kv)
    assert int(err) == 0
    pos = torch.tensor([10, 20])
    mask = torch.arange(32)[None, None, :] <= pos[:, None, None]
    for row, flagged in ((10, 1), (11, 0)):      # batch 0 reads rows <= 10
        q = kv.q.clone()
        q[0, 1, row, 3] ^= 0x04
        bad = kv._replace(q=q)
        rows_t, e_t = tkv.verify_kv(bad, mask)
        rows_j, e_j = jkv.verify_kv(
            jkv.QuantKV(*(jnp.asarray(f.numpy()) for f in bad)),
            jnp.asarray(mask.numpy()))
        assert int(e_t) == int(e_j) == flagged
        np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
        assert int(tkv.verify_kv(bad)[1]) == 1    # unmasked: always seen


def test_update_kv_row_writes_each_batch_row_at_its_own_pos():
    x = _rows(3, (3, 2, 12, 8))
    new = _rows(4, (3, 2, 8))
    kv_t = tkv.quantize_kv_rows(torch.from_numpy(x))
    kv_j = jkv.quantize_kv_rows(jnp.asarray(x))
    # distinct positions per batch row; the last one is past the cache
    # and is dropped, as a JAX scatter drops it
    pos = np.array([0, 7, 12], np.int32)
    bidx = np.arange(3, dtype=np.int32)
    got = tkv.update_kv_row(kv_t, torch.from_numpy(bidx),
                            torch.from_numpy(pos), torch.from_numpy(new))
    want = jkv.update_kv_row(kv_j, jnp.asarray(bidx), jnp.asarray(pos),
                             jnp.asarray(new))
    _equal(got, want)
    nq = tkv.quantize_kv_rows(torch.from_numpy(new))
    for b, p in ((0, 0), (1, 7)):                 # where each row landed
        assert torch.equal(got.q[b, :, p], nq.q[b])
        assert torch.equal(got.rowsum[b, :, p], nq.rowsum[b])
    assert torch.equal(got.q[2], kv_t.q[2])        # the dropped write
    assert torch.equal(got.q[0, :, 1:], kv_t.q[0, :, 1:])
    assert int(tkv.verify_kv(got)[1]) == 0


@pytest.mark.parametrize("window", [None, 5])
def test_attend_quantized_matches_jax(window):
    b, kvh, g, s, dh = 2, 2, 2, 24, 16
    rng = np.random.default_rng(11)
    q = rng.standard_normal((b, kvh * g, dh)).astype(np.float32)
    k, v = _rows(12, (b, kvh, s, dh)), _rows(13, (b, kvh, s, dh))
    pos = np.array([9, 23], np.int32)
    kt, vt = (tkv.quantize_kv_rows(torch.from_numpy(a)) for a in (k, v))
    kj, vj = (jkv.quantize_kv_rows(jnp.asarray(a)) for a in (k, v))
    qq = kt.q.clone()
    qq[1, 0, 4, 2] ^= 0x20                          # one corrupt K row
    kt = kt._replace(q=qq)
    kj = kj._replace(q=jnp.asarray(qq.numpy()))
    kw = dict(n_heads=kvh * g, n_kv=kvh, window=window, prefix_global=2)
    out_t, err_t = tkv.attend_quantized(torch.from_numpy(q), kt, vt,
                                        torch.from_numpy(pos), **kw)
    out_j, err_j = jkv.attend_quantized(jnp.asarray(q), kj, vj,
                                        jnp.asarray(pos), **kw)
    assert int(err_t) == int(err_j) == 1
    want = np.asarray(out_j)
    assert out_t.shape == want.shape == (b, kvh * g, dh)
    scale = np.abs(want).max()
    assert np.abs(out_t.numpy() - want).max() <= _ATTN_TOL * scale


@pytest.mark.parametrize("policy", ["log", "recompute"])
def test_kv_cache_op_reports_as_jax(policy):
    b, kvh, s, dh = 2, 2, 16, 8
    rng = np.random.default_rng(5)
    q = rng.standard_normal((b, 2 * kvh, dh)).astype(np.float32)
    k, v = _rows(1, (b, kvh, s, dh)), _rows(2, (b, kvh, s, dh))
    pos = np.array([15, 6], np.int32)
    plan_text = f"*:policy={policy},kv_cache:on"
    enc_t = (KV_CACHE.encode(torch.from_numpy(k)),
             KV_CACHE.encode(torch.from_numpy(v)))
    vq = enc_t[1].q.clone()
    vq[0, 1, 3, 0] ^= 0x01
    enc_t = (enc_t[0], enc_t[1]._replace(q=vq))
    enc_j = tuple(jkv.QuantKV(*(jnp.asarray(f.numpy()) for f in kv))
                  for kv in enc_t)

    class _Ctx:
        def __init__(self, plan):
            self.plan = plan

    kw = dict(name="attn", n_heads=2 * kvh, n_kv=kvh)
    out_t, rep_t = protected_call(
        "kv_cache", enc_t, torch.from_numpy(q), torch.from_numpy(pos),
        ctx=_Ctx(ProtectionPlan.parse(plan_text)), **kw)
    out_j, rep_j = j_protected_call(
        "kv_cache", enc_j, jnp.asarray(q), jnp.asarray(pos),
        ctx=_Ctx(JPlan.parse(plan_text)), **kw)
    mt = {k_: int(v_) for k_, v_ in rep_t.as_metrics().items()}
    mj = {k_: int(v_) for k_, v_ in rep_j.as_metrics().items()}
    assert mt == {k_: mj[k_] for k_ in mt}
    assert mt["abft/kv_cache_checks"] == 1 and mt["abft/kv_cache_errors"] == 1
    assert mt["abft/retries"] == (1 if policy == "recompute" else 0)
    np.testing.assert_allclose(out_t.numpy(), np.asarray(out_j),
                               rtol=_ATTN_TOL, atol=_ATTN_TOL)


def test_checksums_are_the_jax_checksums():
    rng = np.random.default_rng(9)
    tree = {"a": rng.standard_normal((33, 7)).astype(np.float32),
            "b": {"w": rng.integers(-128, 128, (64, 5)).astype(np.int8),
                  "c": rng.integers(-2**31, 2**31, (40,)).astype(np.int32)},
            # 2**25 bytes of 0xff: the byte sum wraps at 2**32
            "big": np.full((2**25,), 255, np.uint8)}
    t_tree = jax.tree.map(torch.from_numpy, tree)
    j_tree = jax.tree.map(jnp.asarray, tree)
    want = {k: int(v) for k, v in jck.tree_checksum(j_tree).items()}
    got = {k: int(v) for k, v in tck.tree_checksum(t_tree).items()}
    assert got == want and len(got) == 4
    assert tck.verify_tree(t_tree, want)
    t_tree["b"]["w"][3, 2] ^= 1
    assert not tck.verify_tree(t_tree, want)
    for x in (tree["b"]["w"], tree["b"]["c"]):
        for mod in (2147483647, 8191):
            assert int(tck.int_payload_checksum(torch.from_numpy(x), mod)) \
                == int(jck.int_payload_checksum(jnp.asarray(x), mod))
