"""The port's plain kernel versions against the JAX package's Pallas
kernels (interpret mode, as tests/test_kernels.py runs them) and its jnp
oracles, on the same numpy inputs.

Integer outputs (K1's C, row flags and column check; K3's q) must be
bit-exact, and so must K3's alpha/beta against the jnp oracle.  K2's
float outputs agree within rtol 1e-5: the sums over the pool and over d
run in another order.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
# the suite runs in several worker processes on one CPU: one intra-op
# thread keeps torch's idle pool threads off the other workers' cores
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.abft_gemm import (encode_weight_checksum,  # noqa: E402
                                  pack_encoded_b as jax_pack)
from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.abft_embeddingbag import abft_eb_pallas  # noqa: E402
from repro.kernels.abft_qgemm import abft_qgemm_pallas  # noqa: E402
from repro.kernels.quantize_rows import quantize_rows_pallas  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402


def _t(x):
    return torch.from_numpy(np.array(x))


def _packed(rng, k, n, flip=None):
    """Packed B' from numpy, optionally with one bit of B flipped after
    the checksum was taken (a stale checksum, i.e. a corrupted weight)."""
    b = rng.integers(-127, 128, size=(k, n)).astype(np.int8)
    # a host copy now: the flip below writes b in place
    checksum = np.array(encode_weight_checksum(jnp.array(b)))
    if flip is not None:
        idx, bit = flip
        flat = b.reshape(-1).view(np.uint8)
        flat[idx] ^= np.uint8(1 << bit)
    return np.array(jax_pack(jnp.array(b), jnp.array(checksum)))


# ---------------------------- K1: abft_qgemm -------------------------------

# (m, k, n): the DLRM layer shapes at the lookup batch (k = 13 first layer,
# n = 1 last layer), a ragged one and a taller one
QGEMM_SHAPES = [(10, 13, 512), (10, 512, 256), (10, 256, 1),
                (10, 479, 1024), (5, 100, 77), (70, 64, 130)]


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
@pytest.mark.parametrize("m,k,n", QGEMM_SHAPES)
def test_qgemm_plain_matches_pallas(rng, m, k, n, dtype):
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    a = rng.integers(lo, hi, size=(m, k)).astype(dtype)
    bp = _packed(rng, k, n)
    c_p, err_p, col_p = abft_qgemm_pallas(jnp.asarray(a), jnp.asarray(bp),
                                          interpret=True, with_colcheck=True)
    c, err, col = tref.abft_qgemm_ref(_t(a), _t(bp), with_colcheck=True)
    assert c.dtype == torch.int32 and err.dtype == torch.int32
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_p))
    np.testing.assert_array_equal(err.numpy(), np.asarray(err_p))
    np.testing.assert_array_equal(col.numpy(), np.asarray(col_p))
    assert int(err.sum()) == 0


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
@pytest.mark.parametrize("bit", [0, 3, 7])
def test_qgemm_flipped_weight_same_err_rows(rng, dtype, bit):
    m, k, n = 10, 64, 96
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    a = rng.integers(lo, hi, size=(m, k)).astype(dtype)
    bp = _packed(rng, k, n, flip=(int(rng.integers(k * n)), bit))
    _, err_p = abft_qgemm_pallas(jnp.asarray(a), jnp.asarray(bp),
                                 interpret=True)
    _, err = tops.abft_qgemm(_t(a), _t(bp))
    np.testing.assert_array_equal(err.numpy(), np.asarray(err_p))
    assert int(err.sum()) > 0


def test_qgemm_plain_matches_jnp_oracle(rng):
    a = rng.integers(-128, 128, size=(6, 40)).astype(np.int8)
    bp = _packed(rng, 40, 33)
    c_r, err_r = jref.abft_qgemm_ref(jnp.asarray(a), jnp.asarray(bp))
    c, err = tref.abft_qgemm_ref(_t(a), _t(bp))
    np.testing.assert_array_equal(c.numpy(), np.asarray(c_r))
    np.testing.assert_array_equal(err.numpy(), np.asarray(err_r))


def test_qgemm_colcheck_wraps_like_int32(rng):
    # a batch large enough that colsum(A) @ B leaves int32: the JAX
    # reference wraps (int32 accumulation), and so must the port
    m, k, n = 4096, 256, 8
    a = np.full((m, k), 255, np.uint8)
    bp = _packed(rng, k, n)
    bp[:, :n] = 127
    from repro.kernels import ops as jops
    _, _, col_j = jops.abft_qgemm(jnp.asarray(a), jnp.asarray(bp),
                                  use_pallas=False, with_colcheck=True)
    _, _, col = tref.abft_qgemm_ref(_t(a), _t(bp), with_colcheck=True)
    assert 4096 * 255 * 127 * 256 > 2**31
    np.testing.assert_array_equal(col.numpy(), np.asarray(col_j))


# --------------------------- K2: abft_embeddingbag --------------------------

EB_SHAPES = [  # (tables, rows, d, bags, pool)
    (1, 256, 32, 4, 10),
    (3, 512, 128, 10, 16),
    (2, 100, 16, 1, 1),
    (4, 300, 64, 8, 100),
]


def _eb_inputs(rng, tables, rows, d, bags, pool, weighted=False):
    t = rng.integers(-127, 128, size=(tables, rows, d)).astype(np.int8)
    al = rng.uniform(5e-3, 2e-2, size=(tables, rows)).astype(np.float32)
    be = rng.uniform(-0.1, 0.1, size=(tables, rows)).astype(np.float32)
    idx = rng.integers(0, rows, size=(tables, bags, pool)).astype(np.int32)
    # variable pooling with -1 padding, as dlrm_stream makes it
    pools = rng.integers(1, pool + 1, size=(tables, bags))
    idx = np.where(np.arange(pool)[None, None, :] < pools[..., None], idx,
                   -1).astype(np.int32)
    w = (rng.uniform(0.5, 2.0, size=idx.shape).astype(np.float32)
         if weighted else None)
    return t, al, be, idx, w


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tables,rows,d,bags,pool", EB_SHAPES)
def test_eb_plain_matches_pallas(rng, tables, rows, d, bags, pool, weighted):
    t, al, be, idx, w = _eb_inputs(rng, tables, rows, d, bags, pool,
                                   weighted)
    r, rsum = tref.abft_eb_ref(_t(t), _t(al), _t(be), _t(idx),
                               None if w is None else _t(w))
    assert r.shape == (tables, bags, d) and rsum.shape == (tables, bags)
    for i in range(tables):
        r_p, rsum_p = abft_eb_pallas(
            jnp.asarray(t[i]), jnp.asarray(al[i]), jnp.asarray(be[i]),
            jnp.asarray(idx[i]), None if w is None else jnp.asarray(w[i]),
            interpret=True)
        # rtol 1e-5: same terms, summed in another order
        np.testing.assert_allclose(r[i].numpy(), np.asarray(r_p),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rsum[i].numpy(), np.asarray(rsum_p),
                                   rtol=1e-5, atol=1e-4)


def test_eb_padded_slots_and_weights(rng):
    t = rng.integers(-127, 128, size=(64, 32)).astype(np.int8)
    al = rng.uniform(0.01, 0.1, size=64).astype(np.float32)
    be = rng.uniform(-0.1, 0.1, size=64).astype(np.float32)
    idx = np.asarray([[3, 9, -1, -1], [5, -1, -1, -1]], np.int32)
    w = np.asarray([[1.0, 2.0, 9.9, 9.9], [0.5, 9.9, 9.9, 9.9]], np.float32)
    r_j, rsum_j = jref.abft_eb_ref(jnp.asarray(t), jnp.asarray(al),
                                   jnp.asarray(be), jnp.asarray(idx),
                                   jnp.asarray(w))
    r, rsum = tref.abft_eb_ref(_t(t), _t(al), _t(be), _t(idx), _t(w))
    np.testing.assert_allclose(r.numpy(), np.asarray(r_j), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(rsum.numpy(), np.asarray(rsum_j), rtol=1e-5,
                               atol=1e-5)


def test_eb_ops_stacked_flags_match_per_table_jax(rng):
    # the stacked call checks each table's bags exactly as a per-table
    # JAX call does, including a high bit flipped in a row one bag reads
    from repro.core.abft_embedding import table_rowsums
    from repro.kernels import ops as jops
    from repro_torch.core import table_rowsums as t_rowsums
    t, al, be, idx, _ = _eb_inputs(rng, 3, 128, 32, 6, 12)
    rs = np.stack([np.asarray(table_rowsums(jnp.asarray(x))) for x in t])
    np.testing.assert_array_equal(t_rowsums(_t(t)).numpy(), rs)
    row = int(idx[1, 2, 0])
    t[1, row, 7] ^= np.int8(-128)                       # bit 7, stale C_T
    out = tops.abft_embedding_bag(_t(t), _t(al), _t(be), _t(idx), _t(rs))
    assert out.err_count.shape == (3,)
    for i in range(3):
        ref = jops.abft_embedding_bag(
            jnp.asarray(t[i]), jnp.asarray(al[i]), jnp.asarray(be[i]),
            jnp.asarray(idx[i]), jnp.asarray(rs[i]), use_pallas=False)
        np.testing.assert_array_equal(out.err_bags[i].numpy(),
                                      np.asarray(ref.err_bags))
        assert int(out.err_count[i]) == int(ref.err_count)
    assert int(out.err_count[1]) >= 1


# ---------------------------- K3: quantize_rows ----------------------------

@pytest.mark.parametrize("bf16", [False, True])
@pytest.mark.parametrize("m,n", [(10, 13), (10, 479), (64, 1024), (3, 12288),
                                 (1, 1)])
def test_quantize_rows_plain_bit_exact(rng, m, n, bf16):
    x = (rng.standard_normal((m, n)) * 3.0).astype(np.float32)
    if bf16:
        # the DLRM activations arrive in bf16: round them the same way
        # on both sides, then both wrappers cast to float32
        x = np.asarray(jnp.asarray(x).astype(jnp.bfloat16)
                       .astype(jnp.float32))
    q, a, b = tops.quantize_rows(_t(x))
    q_r, a_r, b_r = jref.quantize_rows_ref(jnp.asarray(x))
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_r))
    np.testing.assert_array_equal(a.numpy(), np.asarray(a_r))
    np.testing.assert_array_equal(b.numpy(), np.asarray(b_r))
    # the interpreted Pallas kernel lets XLA turn the division by 255 into
    # a multiply by its inexact reciprocal: its alpha sits up to one
    # float32 ulp off the true quotient, beta = xmin + 128 alpha (folded
    # the same way: two roundings of 128 alpha) up to 2 x 128 of alpha's
    # ulps plus its own rounding, and
    # a q next to a rounding tie can move by one (1.2%
    # of a bf16-rounded [10, 479] input; see ROADMAP §C).  The port
    # follows the oracle above, which divides.
    q_p, a_p, b_p = (np.asarray(v) for v in
                     quantize_rows_pallas(jnp.asarray(x), interpret=True))
    assert np.max(np.abs(q.numpy().astype(int) - q_p.astype(int))) <= 1
    ulp_a = np.spacing(a_p)
    assert np.all(np.abs(a.numpy() - a_p) <= ulp_a)
    assert np.all(np.abs(b.numpy() - b_p)
                  <= 256 * ulp_a + 2 * np.spacing(np.abs(b_p)))


def test_quantize_rows_casts_bf16_input(rng):
    x = torch.from_numpy(rng.standard_normal((4, 64)).astype(np.float32))
    q1, a1, b1 = tops.quantize_rows(x.to(torch.bfloat16))
    q2, a2, b2 = tops.quantize_rows(x.to(torch.bfloat16).to(torch.float32))
    assert torch.equal(q1, q2) and torch.equal(a1, a2) and torch.equal(b1, b2)


# ------------------------------- dispatch ----------------------------------

def test_cpu_tensors_take_the_plain_version(rng, monkeypatch):
    # poison the kernel wrappers: the CPU path must never reach them
    import repro_torch.kernels.abft_embeddingbag as eb_mod
    import repro_torch.kernels.abft_qgemm as qg_mod
    import repro_torch.kernels.quantize_rows as qr_mod

    def _boom(*a, **kw):
        raise AssertionError("a CPU tensor reached a CUDA kernel")

    monkeypatch.setattr(qg_mod, "abft_qgemm_cuda", _boom)
    monkeypatch.setattr(eb_mod, "abft_eb_cuda", _boom)
    monkeypatch.setattr(qr_mod, "quantize_rows_cuda", _boom)
    a = _t(rng.integers(-128, 128, size=(4, 32)).astype(np.int8))
    bp = _t(_packed(rng, 32, 16))
    for use_kernel in (None, False):
        c, err = tops.abft_qgemm(a, bp, use_kernel=use_kernel)
        assert int(err.sum()) == 0
        q, _, _ = tops.quantize_rows(c.float(), use_kernel=use_kernel)
        assert q.dtype == torch.int8
    t, al, be, idx, _ = _eb_inputs(rng, 2, 64, 16, 3, 5)
    from repro_torch.core import table_rowsums
    out = tops.abft_embedding_bag(_t(t), _t(al), _t(be), _t(idx),
                                  table_rowsums(_t(t)), use_kernel=False)
    assert int(out.err_count.sum()) == 0


def test_forcing_the_kernel_on_cpu_raises(rng):
    a = _t(rng.integers(-128, 128, size=(4, 32)).astype(np.int8))
    bp = _t(_packed(rng, 32, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tops.abft_qgemm(a, bp, use_kernel=True)
    with pytest.raises(ValueError, match="CUDA"):
        tops.quantize_rows(a.float(), use_kernel=True)
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    with pytest.raises(ValueError, match="CUDA"):
        abft_qgemm_cuda(a, bp)
    with pytest.raises(ValueError, match="CUDA"):
        quantize_rows_cuda(a.float())
    t, al, be, idx, _ = _eb_inputs(rng, 1, 16, 8, 2, 3)
    with pytest.raises(ValueError, match="CUDA"):
        abft_eb_cuda(_t(t), _t(al), _t(be), _t(idx))
