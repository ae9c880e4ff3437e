"""K2's arithmetic, written plainly, against the JAX package.

K2 sums each element of R over the slots in slot order, and makes the
Eq. (5) compare of ``verify_bags`` itself, its sums in slot order too.
Its plain mirrors (``kernels/ref.abft_eb_slot_order_ref`` and
``kernels/ref.eb_check_slot_order``) are held here, on the CPU, against
the JAX package on the same numpy inputs: R against the interpreted
Pallas kernel and the jnp oracle within K2's existing tolerance (rtol
1e-5: the same rounded terms, summed in another order), and the flags
against the port's and the JAX ``verify_bags`` — clean, and with each of
the 8 bits of a table byte flipped, at ``rel_bound`` 1e-3, 1e-5 and 1e-7.

Exact agreement of flags between two summation orders holds only where
the compare is decided by more than round-off.  At 1e-7 the bound is
about one float32 ulp of a bag's magnitude, so on random scales the
round-off alone decides some clean bags.  The flag tests therefore use
dyadic scales (alpha, beta and the weights multiples of 2^-10 and 2^-1,
every sum exact in float32): there every order gives the same sums, and
the flags must agree bit for bit at all three bounds.  On random scales
they must agree at 1e-3 and 1e-5, and at 1e-7 wherever the margin
exceeds the orders' round-off.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.abft_embedding import verify_bags as jax_verify  # noqa: E402
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.abft_embeddingbag import abft_eb_pallas  # noqa: E402
from repro_torch.core import table_rowsums, verify_bags  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

REL_BOUNDS = [1e-3, 1e-5, 1e-7]


def _t(x):
    return torch.from_numpy(np.array(x))


def _inputs(rng, tables, rows, d, bags, pool, *, weighted, dyadic=False,
            padding="tail"):
    t = rng.integers(-127, 128, size=(tables, rows, d)).astype(np.int8)
    if dyadic:
        al = rng.integers(1, 5, size=(tables, rows)) * 2.0**-10
        be = rng.integers(-100, 101, size=(tables, rows)) * 2.0**-10
        w = rng.integers(1, 5, size=(tables, bags, pool)) * 0.5
    else:
        al = rng.uniform(5e-3, 2e-2, size=(tables, rows))
        be = rng.uniform(-0.1, 0.1, size=(tables, rows))
        w = rng.uniform(0.5, 2.0, size=(tables, bags, pool))
    if padding == "anywhere":
        # -1 at any slot, and the first bag of each table padded whole
        idx = rng.integers(-1, rows, size=(tables, bags, pool))
        idx[:, 0, :] = -1
    else:
        idx = rng.integers(0, rows, size=(tables, bags, pool))
        # variable pooling with -1 padding, as dlrm_stream makes it
        pools = rng.integers(1, pool + 1, size=(tables, bags))
        idx = np.where(np.arange(pool)[None, None, :] < pools[..., None],
                       idx, -1)
    return (t, al.astype(np.float32), be.astype(np.float32),
            idx.astype(np.int32), w.astype(np.float32) if weighted else None)


def _flags_all_ways(t, al, be, idx, w, rs, rel):
    """(slot-order mirror, port verify_bags, JAX verify_bags) flags of a
    stack, all from one rsum (the plain R's) and the stale C_T ``rs``."""
    d = t.shape[-1]
    w_t = None if w is None else _t(w)
    _, rsum = tref.abft_eb_ref(_t(t), _t(al), _t(be), _t(idx), w_t)
    mirror = tref.eb_check_slot_order(rsum, _t(al), _t(be), _t(idx), _t(rs),
                                      d, w_t, rel).numpy()
    port = np.stack([verify_bags(rsum[i], _t(al[i]), _t(be[i]), _t(idx[i]),
                                 _t(rs[i]), d, None if w is None
                                 else w_t[i], rel).numpy()
                     for i in range(t.shape[0])])
    jax = np.stack([np.asarray(jax_verify(
        jnp.asarray(rsum[i].numpy()), jnp.asarray(al[i]), jnp.asarray(be[i]),
        jnp.asarray(idx[i]), jnp.asarray(rs[i]), d,
        None if w is None else jnp.asarray(w[i]), rel))
        for i in range(t.shape[0])])
    return mirror, port, jax


@pytest.mark.parametrize("padding", ["tail", "anywhere"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tables,rows,d,bags,pool", [
    (3, 512, 128, 10, 16), (2, 300, 128, 6, 100), (1, 256, 2048, 4, 1),
    (2, 64, 40, 5, 100), (1, 8, 300, 3, 2)])
def test_slot_order_sum_matches_pallas(rng, tables, rows, d, bags, pool,
                                       weighted, padding):
    t, al, be, idx, w = _inputs(rng, tables, rows, d, bags, pool,
                                weighted=weighted, padding=padding)
    r = tref.abft_eb_slot_order_ref(_t(t), _t(al), _t(be), _t(idx),
                                    None if w is None else _t(w)).numpy()
    assert r.shape == (tables, bags, d)
    for i in range(tables):
        args = (jnp.asarray(t[i]), jnp.asarray(al[i]), jnp.asarray(be[i]),
                jnp.asarray(idx[i]), None if w is None else jnp.asarray(w[i]))
        r_p, _ = abft_eb_pallas(*args, interpret=True)
        r_o, _ = jref.abft_eb_ref(*args)
        # rtol 1e-5: the same rounded terms, summed in another order
        np.testing.assert_allclose(r[i], np.asarray(r_p), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(r[i], np.asarray(r_o), rtol=1e-5,
                                   atol=1e-5)


def test_slot_order_sum_is_a_loop_over_slots(rng):
    # R[b, j] = (((0 + t_0) + t_1) + ...) with t_p = w (alpha row + beta),
    # each operation rounded to float32, padded slots row 0 with weight 0
    t, al, be, idx, w = _inputs(rng, 1, 50, 32, 3, 7, weighted=True)
    r = tref.abft_eb_slot_order_ref(_t(t), _t(al), _t(be), _t(idx), _t(w))
    f32 = np.float32
    for b in range(3):
        acc = np.zeros(32, f32)
        for p in range(7):
            i = idx[0, b, p]
            row, wp = (i, w[0, b, p]) if i >= 0 else (0, f32(0))
            deq = (al[0, row] * t[0, row].astype(f32)).astype(f32) \
                + be[0, row]
            acc = (acc + (wp * deq).astype(f32)).astype(f32)
        np.testing.assert_array_equal(r[0, b].numpy(), acc)


@pytest.mark.parametrize("d,warps", [(64, 1), (1536, 3), (2048, 4),
                                     (9216, 8)])
def test_team_order_rsum_is_lanes_then_butterfly_then_warps(rng, d, warps):
    # each lane's words in column order from 0, the xor butterfly inside
    # each warp, the warps in order: every addition rounded to float32
    r = (rng.standard_normal((3, d)) * 10).astype(np.float32)
    got = tref.eb_rsum_team_order(_t(r), warps).numpy()
    f32 = np.float32
    team, n_words = 32 * warps, d // 16
    assert got.shape == (3,)
    for b in range(3):
        part = np.zeros(team, f32)
        for lane in range(team):
            for w in range(lane, n_words, team):
                for e in range(16):
                    part[lane] = f32(part[lane] + r[b, 16 * w + e])
        part = part.reshape(warps, 32)
        for off in (16, 8, 4, 2, 1):
            part = (part + part[:, np.arange(32) ^ off]).astype(f32)
        want = part[0, 0]
        for k in range(1, warps):
            want = f32(want + part[k, 0])
        assert got[b] == want
    # a float32 sum of d terms: within gamma_h x sum|R| of the exact sum
    h = 16 * -(-n_words // team) + 5 + warps
    exact = r.astype(np.float64).sum(-1)
    assert np.all(np.abs(got - exact)
                  <= h * 2.0**-24 * np.abs(r).astype(np.float64).sum(-1))


def test_slot_order_sum_clamps_past_the_table(rng):
    t, al, be, idx, _ = _inputs(rng, 2, 40, 16, 3, 5, weighted=False)
    past = idx.copy()
    past[idx == 39] = 39 + 1000          # past the table: its last row
    past[0, 0, 0] = 2**31 - 1
    clamped = idx.copy()
    clamped[0, 0, 0] = 39
    got = tref.abft_eb_slot_order_ref(_t(t), _t(al), _t(be), _t(past))
    want = tref.abft_eb_slot_order_ref(_t(t), _t(al), _t(be), _t(clamped))
    assert torch.equal(got, want)


@pytest.mark.parametrize("padding", ["tail", "anywhere"])
@pytest.mark.parametrize("rel", REL_BOUNDS)
@pytest.mark.parametrize("weighted", [False, True])
def test_check_mirror_clean_and_bit_flips_dyadic(rng, rel, weighted,
                                                 padding):
    # exact sums in every order: the flags agree bit for bit at every bound
    t, al, be, idx, w = _inputs(rng, 3, 200, 128, 10, 16, weighted=weighted,
                                dyadic=True, padding=padding)
    rs = table_rowsums(_t(t)).numpy()
    clean = _flags_all_ways(t, al, be, idx, w, rs, rel)
    for got in clean:
        assert not got.any()
    tab, bag = 1, 4
    row, col = int(idx[tab, bag][idx[tab, bag] >= 0][0]), 77
    counts = []
    for bit in range(8):
        flipped = t.copy()
        flipped[tab, row, col] ^= np.int8(-128 if bit == 7 else 1 << bit)
        mirror, port, jax = _flags_all_ways(flipped, al, be, idx, w, rs, rel)
        np.testing.assert_array_equal(mirror, port)
        np.testing.assert_array_equal(mirror, jax)
        assert not mirror[0].any() and not mirror[2].any()
        counts.append(int(mirror.sum()))
    # the bag that reads the row is flagged from some bit on, and the
    # high bit is caught at every bound
    assert counts[7] >= 1
    assert counts == sorted(counts)


@pytest.mark.parametrize("rel", REL_BOUNDS[:2])
@pytest.mark.parametrize("weighted", [False, True])
def test_check_mirror_clean_and_bit_flips_random(rng, rel, weighted):
    t, al, be, idx, w = _inputs(rng, 3, 512, 128, 10, 16, weighted=weighted)
    rs = table_rowsums(_t(t)).numpy()
    for got in _flags_all_ways(t, al, be, idx, w, rs, rel):
        assert not got.any()
    tab, bag = 2, 7
    row, col = int(idx[tab, bag, 0]), 5
    for bit in range(8):
        flipped = t.copy()
        flipped[tab, row, col] ^= np.int8(-128 if bit == 7 else 1 << bit)
        mirror, port, jax = _flags_all_ways(flipped, al, be, idx, w, rs, rel)
        np.testing.assert_array_equal(mirror, port)
        np.testing.assert_array_equal(mirror, jax)
    assert mirror[tab, bag]                       # bit 7 is caught


def test_check_mirror_at_1e7_differs_only_by_round_off(rng):
    # random scales at rel_bound 1e-7: the bound is ~1 ulp of the bag's
    # magnitude, so round-off decides some clean bags; the orders may
    # disagree only where |rsum - csum| lies within a few ulps of the bound
    rel = 1e-7
    t, al, be, idx, w = _inputs(rng, 4, 1000, 128, 200, 16, weighted=True)
    rs = table_rowsums(_t(t)).numpy()
    mirror, port, jax = _flags_all_ways(t, al, be, idx, w, rs, rel)
    _, rsum = tref.abft_eb_ref(_t(t), _t(al), _t(be), _t(idx), _t(w))
    a, b = al[np.arange(4)[:, None, None], np.maximum(idx, 0)], \
        be[np.arange(4)[:, None, None], np.maximum(idx, 0)]
    ct = rs[np.arange(4)[:, None, None], np.maximum(idx, 0)]
    wv = np.where(idx >= 0, w, 0.0)
    csum = np.sum(wv * (a * ct + 128 * b), axis=-1, dtype=np.float64)
    mag = np.sum(np.abs(wv) * (np.abs(a) * np.abs(ct) + 128 * np.abs(b)),
                 axis=-1, dtype=np.float64)
    margin = np.abs(np.abs(rsum.numpy() - csum) - rel * np.maximum(mag, 1))
    # each order's float32 csum is within pool / 2 = 8 ulps of mag of the
    # exact one
    near = margin <= 16 * np.spacing(mag.astype(np.float32))
    for other in (port, jax):
        assert not ((mirror != other) & ~near).any()
    assert near.any() and mirror.any()     # the case this test is about


def test_card_branch_formula_matches_ops_plain_path(rng):
    # the mirror on the plain path's own rsum gives the flags and counts
    # ops.abft_embedding_bag's plain path gives (random scales, 1e-5)
    t, al, be, idx, w = _inputs(rng, 3, 512, 128, 10, 16, weighted=True)
    rs = table_rowsums(_t(t))
    row = int(idx[0, 3, 1])
    t[0, row, 11] ^= np.int8(-128)                 # stale C_T, bit 7
    out = tops.abft_embedding_bag(_t(t), _t(al), _t(be), _t(idx), rs, _t(w))
    _, rsum = tref.abft_eb_ref(_t(t), _t(al), _t(be), _t(idx), _t(w))
    flags = tref.eb_check_slot_order(rsum, _t(al), _t(be), _t(idx), rs, 128,
                                     _t(w))
    assert torch.equal(flags, out.err_bags)
    assert torch.equal(flags.sum(-1, dtype=torch.int32), out.err_count)
    assert int(out.err_count[0]) >= 1
