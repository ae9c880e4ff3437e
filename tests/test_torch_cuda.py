"""The CUDA kernels against their plain versions, on the card.

A CUDA kernel has no interpret mode, so these tests need a GPU; they are
marked ``cuda`` and skip without one.  On a machine with a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import pack_encoded_b, table_rowsums  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _packed(rng, k, n, dev):
    b = torch.from_numpy(rng.integers(-127, 128, size=(k, n))
                         .astype(np.int8))
    return pack_encoded_b(b).to(dev)


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
@pytest.mark.parametrize("m,k,n", [(10, 13, 512), (10, 256, 1), (1, 64, 64),
                                   (130, 70, 300), (65, 1024, 129)])
def test_qgemm_kernel_bit_exact(rng, dev, m, k, n, dtype):
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    a = torch.from_numpy(rng.integers(lo, hi, size=(m, k)).astype(dtype))
    a = a.to(dev)
    bp = _packed(rng, k, n, dev)
    got = ops.abft_qgemm(a, bp, with_colcheck=True)
    want = ref.abft_qgemm_ref(a, bp, with_colcheck=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    bp[k // 2, n // 2] ^= 0x04                  # stale checksum lane
    g_err = ops.abft_qgemm(a, bp)[1]
    assert torch.equal(g_err, ref.abft_qgemm_ref(a, bp)[1])
    assert int(g_err.sum()) > 0


@pytest.mark.parametrize("m,n", [(10, 13), (10, 479), (7, 12288), (300, 64)])
def test_quantize_rows_kernel_bit_exact(rng, dev, m, n):
    x = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    x = x.to(dev).to(torch.bfloat16)
    for g, w in zip(ops.quantize_rows(x), ref.quantize_rows_ref(x)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tables,rows,d,bags,pool", [(3, 1000, 128, 10, 16),
                                                     (2, 64, 40, 5, 100),
                                                     (1, 8, 300, 3, 2)])
def test_eb_kernel_matches_plain(rng, dev, tables, rows, d, bags, pool,
                                 weighted):
    t = torch.from_numpy(rng.integers(-127, 128, size=(tables, rows, d))
                         .astype(np.int8)).to(dev)
    al = torch.from_numpy(rng.uniform(5e-3, 2e-2, size=(tables, rows))
                          .astype(np.float32)).to(dev)
    be = torch.from_numpy(rng.uniform(-0.1, 0.1, size=(tables, rows))
                          .astype(np.float32)).to(dev)
    idx = torch.from_numpy(rng.integers(-1, rows, size=(tables, bags, pool))
                           .astype(np.int32)).to(dev)
    w = (torch.from_numpy(rng.uniform(0.5, 2, size=(tables, bags, pool))
                          .astype(np.float32)).to(dev) if weighted else None)
    out_k = ops.abft_embedding_bag(t, al, be, idx, table_rowsums(t), w)
    out_p = ops.abft_embedding_bag(t, al, be, idx, table_rowsums(t), w,
                                   use_kernel=False)
    # same rounded terms summed in another order
    torch.testing.assert_close(out_k.r, out_p.r, rtol=1e-5, atol=1e-5)
    assert torch.equal(out_k.err_bags, out_p.err_bags)
    assert int(out_k.err_count.sum()) == 0
