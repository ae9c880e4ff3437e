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


def _misaligned(a):
    """``a`` copied to one byte past a 16-byte boundary (still contiguous),
    so the kernel must take its masked path."""
    flat = torch.empty(a.numel() + 16, dtype=a.dtype, device=a.device)
    out = flat[1:1 + a.numel()].view(a.shape)
    out.copy_(a)
    assert out.is_contiguous() and out.data_ptr() % 16 == 1
    return out


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
@pytest.mark.parametrize("flip", ["middle", "last_split", "checksum"])
@pytest.mark.parametrize("m,k,n,fill", [
    (10, 13, 512, "random"), (10, 256, 1, "random"), (1, 64, 64, "random"),
    (130, 70, 300, "random"), (65, 1024, 129, "random"),
    # the RWKV serving shapes: split K across a cluster, the head unsplit
    (64, 2048, 2048, "random"), (4, 7168, 2048, "random"),
    (1, 2048, 65536, "random"),
    # the extremes of the int32 sums and of the column check's wraparound
    (64, 7168, 2048, "extreme"),
    # A off 16-byte alignment at an otherwise aligned shape
    (64, 2048, 2048, "misaligned")])
def test_qgemm_kernel_bit_exact(rng, dev, m, k, n, fill, flip, dtype):
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda, launch_plan
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    if fill == "extreme":
        a = np.full((m, k), lo if dtype == "int8" else hi - 1, dtype=dtype)
        bp = pack_encoded_b(torch.full((k, n), -127,
                                       dtype=torch.int8)).to(dev)
    else:
        a = rng.integers(lo, hi, size=(m, k)).astype(dtype)
        bp = _packed(rng, k, n, dev)
    a = torch.from_numpy(a).to(dev)
    if fill == "misaligned":
        a = _misaligned(a)
        assert not launch_plan(m, k, n, a_addr=a.data_ptr(),
                               b_addr=bp.data_ptr()).aligned
    before = abft_qgemm_cuda.launches
    got = ops.abft_qgemm(a, bp, with_colcheck=True)
    want = ref.abft_qgemm_ref(a, bp, with_colcheck=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) == 0
    plain_path = ops.abft_qgemm(a, bp)         # the kernel without the check
    for g, w in zip(plain_path, want[:2]):
        assert torch.equal(g, w)
    assert abft_qgemm_cuda.launches == before + 2
    first, last = launch_plan(m, k, n).k_ranges(k)[-1]
    row, lane = {"middle": (k // 2, n // 2),
                 # a payload bit in the last K split's range
                 "last_split": ((first + last) // 2, n - 1),
                 # the checksum lane itself
                 "checksum": (k // 2, n)}[flip]
    # the flip shows in a row's check only where A[i, row] * 4 is not 0
    # mod 127: take the next k row where some A[i, row] qualifies
    live = (a.cpu().to(torch.int64) % 127 != 0).any(dim=0).nonzero()
    row = int(live[live >= row].min())
    bp[row, lane] ^= 0x04
    g_err = ops.abft_qgemm(a, bp)[1]
    assert torch.equal(g_err, ref.abft_qgemm_ref(a, bp)[1])
    assert int(g_err.sum()) > 0


@pytest.mark.parametrize("m,n", [(10, 13), (10, 479), (7, 12288), (300, 64)])
def test_quantize_rows_kernel_bit_exact(rng, dev, m, n):
    x = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    x = x.to(dev).to(torch.bfloat16)
    for g, w in zip(ops.quantize_rows(x), ref.quantize_rows_ref(x)):
        assert torch.equal(g, w)


# the rows K3 sees on the two serving paths: every DLRM layer's input
# width at the lookup batch, the RWKV projections' at prefill (64),
# decode (4) and the head in a prefill (1); and a ragged odd width
K3_SHAPES = ([(10, k) for k in (13, 512, 256, 479, 1024)]
             + [(m, k) for m in (64, 4, 1) for k in (2048, 7168)]
             + [(3, 1001)])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("m,n", K3_SHAPES)
def test_quantize_rows_kernel_reads_bf16(rng, dev, m, n, dtype):
    """K3 reads float32 and bfloat16 as they are: q, alpha, beta bit-exact
    with the plain version on the float32 cast, one launch, no cast."""
    from repro_torch.kernels.quantize_rows import quantize_rows_cuda
    x = torch.from_numpy((rng.standard_normal((m, n)) * 3)
                         .astype(np.float32)).to(dev)
    x = x.to(getattr(torch, dtype))
    before = quantize_rows_cuda.launches
    got = ops.quantize_rows(x)
    assert quantize_rows_cuda.launches == before + 1
    for g, w in zip(got, ref.quantize_rows_ref(x.float())):
        assert torch.equal(g, w)


def test_quantize_rows_kernel_at_ties(dev):
    """Rows whose quotients (x - beta) / alpha fall on half-integers and
    just beside them: the kernel multiplies by 1/alpha and divides exactly
    only near a tie, and must round as the IEEE quotient does."""
    half = torch.arange(511, dtype=torch.float32) * 0.5     # alpha 1, beta 128
    near = half + torch.tensor([0.0, 3e-5, -3e-5, 1e-6, -1e-6]).repeat(103)[
        :511]
    scaled = half * 0.37 - 11.0                             # alpha 0.37
    x = torch.stack([half, near, scaled, scaled.flip(0)]).to(dev)
    for g, w in zip(ops.quantize_rows(x), ref.quantize_rows_ref(x)):
        assert torch.equal(g, w)


def _k1_case(rng, m, k, n, dev):
    a = torch.from_numpy(rng.integers(-128, 128, size=(m, k))
                         .astype(np.int8)).to(dev)
    return a, _packed(rng, k, n, dev)


def _k1_equal(got, a, bp):
    want = ref.abft_qgemm_ref(a, bp)
    return all(torch.equal(g, w) for g, w in zip(got, want))


# (m, k, n) of K1 in the hazard positions: a DLRM layer (the masked path),
# the RWKV prefill and decode projections (split K), the head
PDL_SHAPES = [(10, 479, 1024), (64, 2048, 2048), (4, 7168, 2048),
              (1, 2048, 65536)]


@pytest.mark.parametrize("m,k,n", PDL_SHAPES)
def test_qgemm_pdl_after_quantize_rows(rng, dev, m, k, n):
    """K1 launched as K3's programmatic dependent, with no synchronisation
    in between: bit-exact with the plain version on K3's output."""
    bp = _packed(rng, k, n, dev)
    xs = [torch.from_numpy(rng.standard_normal((m, k)).astype(np.float32))
          .to(dev).to(torch.bfloat16) for _ in range(4)]
    outs = []
    for x in xs:                        # K3 -> K1, K3 -> K1, ...
        q = ops.quantize_rows(x)[0]
        outs.append((q, ops.abft_qgemm(q, bp)))
    for x, (q, got) in zip(xs, outs):
        assert torch.equal(q, ref.quantize_rows_ref(x.float())[0])
        assert _k1_equal(got, q, bp)
        assert int(got[1].sum()) == 0


@pytest.mark.parametrize("m,k,n", PDL_SHAPES)
def test_qgemm_pdl_after_in_place_flip(rng, dev, m, k, n):
    """K1 right after a kernel that flips a B' byte in place sees the
    flipped byte (and, after the flip back, the clean one)."""
    a, bp = _k1_case(rng, m, k, n, dev)
    a[:, k // 3] = 1                    # so the flipped row shows
    clean = ops.abft_qgemm(a, bp)
    bp[k // 3, n // 2] ^= 0x10          # an elementwise kernel on B'
    flipped = ops.abft_qgemm(a, bp)
    bp[k // 3, n // 2] ^= 0x10
    restored = ops.abft_qgemm(a, bp)
    torch.cuda.synchronize()
    assert int(clean[1].sum()) == 0 and int(restored[1].sum()) == 0
    assert int(flipped[1].sum()) == m
    assert _k1_equal(restored, a, bp)
    bp[k // 3, n // 2] ^= 0x10
    assert _k1_equal(flipped, a, bp)


@pytest.mark.parametrize("m,k,n", PDL_SHAPES)
def test_qgemm_pdl_after_qgemm_on_same_scratch(rng, dev, m, k, n):
    """Back-to-back K1 calls on one stream share the row-sum and ticket
    scratch that each leaves zeroed (as ``recompute`` runs K1 twice)."""
    cases = [_k1_case(rng, m, k, n, dev) for _ in range(2)]
    cases[1][1][7, 3] ^= 0x20           # the second one flagged
    cases[1][0][:, 7] = 1
    outs = [ops.abft_qgemm(a, bp) for a, bp in cases * 3]
    for (a, bp), got in zip(cases * 3, outs):
        assert _k1_equal(got, a, bp)
    assert [int(o[1].sum()) for o in outs] == [0, m] * 3


def test_qgemm_pdl_after_correct_repair(rng, dev):
    """Under ``correct`` a flipped weight is repaired in C; the K1 launched
    right after the repair's kernels is bit-exact, and so is the repair."""
    from repro_torch.protect.plan import ResolvedRule
    from repro_torch.protect.runtime import protected_call
    m, k, n = 64, 2048, 2048
    a, bp = _k1_case(rng, m, k, n, dev)
    colsum = ops.abft_qgemm(a.new_ones((1, k)), bp)[0][0]   # sum of B
    clean_c = ops.abft_qgemm(a, bp)[0]
    bp[100, 200] ^= 0x08
    rule = ResolvedRule(policy="correct")
    a2, bp2 = _k1_case(rng, 4, k, n, dev)
    fixed, report = protected_call("qgemm", (bp, colsum), a, rule=rule)
    after = ops.abft_qgemm(a2, bp2)     # right behind the repair
    bp[100, 200] ^= 0x08
    assert torch.equal(fixed, clean_c)
    assert int(report.corrections) == 1
    assert _k1_equal(after, a2, bp2)


def _eb_case(rng, dev, tables, rows, d, bags, pool, weighted=False,
             dyadic=False, padding="tail"):
    """A stack of int8 tables with their scales and C_T, and padded
    indices, optionally weighted; ``dyadic`` scales make every sum exact
    in float32, so the flags do not depend on the order.  ``padding``
    "tail" pads each bag after a random pool of at least one slot;
    "anywhere" draws -1 at any slot and pads the first bag of each table
    whole."""
    t = rng.integers(-127, 128, size=(tables, rows, d)).astype(np.int8)
    if dyadic:
        al = rng.integers(1, 5, size=(tables, rows)) * 2.0**-10
        be = rng.integers(-100, 101, size=(tables, rows)) * 2.0**-10
        w = rng.integers(1, 5, size=(tables, bags, pool)) * 0.5
    else:
        al = rng.uniform(5e-3, 2e-2, size=(tables, rows))
        be = rng.uniform(-0.1, 0.1, size=(tables, rows))
        w = rng.uniform(0.5, 2, size=(tables, bags, pool))
    if padding == "anywhere":
        idx = rng.integers(-1, rows, size=(tables, bags, pool))
        idx[:, 0, :] = -1
    else:
        idx = rng.integers(0, rows, size=(tables, bags, pool))
        pools = rng.integers(1, pool + 1, size=(tables, bags))
        idx = np.where(np.arange(pool)[None, None, :] < pools[..., None],
                       idx, -1)
    t = torch.from_numpy(t).to(dev)
    out = [t, torch.from_numpy(al.astype(np.float32)).to(dev),
           torch.from_numpy(be.astype(np.float32)).to(dev),
           torch.from_numpy(idx.astype(np.int32)).to(dev), table_rowsums(t)]
    return out + [torch.from_numpy(w.astype(np.float32)).to(dev)
                  if weighted else None]


def _eb_held(t, al, be, idx, rs, w, rel, *, exact_flags=True):
    """K2 (through the card branch and its wrapper) against the plain
    versions: R bit-exact with the slot-order sum, rsum within 1e-5 of
    d x max|R|, the flags and counts equal to the mirror on K2's own rsum
    and (``exact_flags``) to the plain branch.  Returns the flags."""
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    d = t.shape[-1]
    before = abft_eb_cuda.launches
    out = ops.abft_embedding_bag(t, al, be, idx, rs, w, rel_bound=rel)
    assert abft_eb_cuda.launches == before + 1          # one kernel a call
    r, rsum, flags, count = abft_eb_cuda(t, al, be, idx, rs, w,
                                         rel_bound=rel)
    assert torch.equal(out.r, r) and torch.equal(out.err_bags, flags)
    assert torch.equal(out.err_count, count)
    assert torch.equal(r, ref.abft_eb_slot_order_ref(t, al, be, idx, w))
    idx_c = idx.clamp(max=t.shape[1] - 1)
    plain = ops.abft_embedding_bag(t, al, be, idx_c, rs, w, rel_bound=rel,
                                   use_kernel=False)
    _, rsum_p = ref.abft_eb_ref(t, al, be, idx_c, w)
    scale = max(1.0, float(plain.r.abs().max()))
    assert float((rsum - rsum_p).abs().max()) <= 1e-5 * d * scale
    mirror = ref.eb_check_slot_order(rsum, al, be, idx, rs, d, w, rel)
    assert torch.equal(flags, mirror)
    assert torch.equal(count, flags.sum(-1, dtype=torch.int32))
    if exact_flags:
        assert torch.equal(flags, plain.err_bags)
        assert torch.equal(count, plain.err_count)
    return flags


# (tables, rows, d, bags, pool): a DLRM request and the Table I pooling at
# d 128, the RWKV token table's d 2048 at pool 1 (64 and 4 bags), the
# narrow vector widths, and ragged d (byte loads)
EB_CARD_SHAPES = [(3, 1000, 128, 10, 16), (2, 64, 40, 5, 100),
                  (1, 8, 300, 3, 2), (26, 4096, 128, 10, 16),
                  (4, 5000, 128, 300, 100), (1, 65536, 2048, 64, 1),
                  (1, 65536, 2048, 4, 1), (2, 300, 16, 9, 33),
                  (2, 300, 32, 9, 20), (2, 300, 64, 9, 20),
                  (2, 300, 256, 9, 40), (2, 300, 48, 9, 20),
                  (1, 50, 4096, 3, 5)]


@pytest.mark.parametrize("padding", ["tail", "anywhere"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tables,rows,d,bags,pool", EB_CARD_SHAPES)
def test_eb_kernel_matches_plain(rng, dev, tables, rows, d, bags, pool,
                                 weighted, padding):
    t, al, be, idx, rs, w = _eb_case(rng, dev, tables, rows, d, bags, pool,
                                     weighted, padding=padding)
    for rel in (1e-3, 1e-5):
        assert not _eb_held(t, al, be, idx, rs, w, rel).any()
    # at 1e-7 round-off decides some clean bags on random scales: K2 must
    # equal its mirror on its own rsum (checked inside), not every order
    _eb_held(t, al, be, idx, rs, w, 1e-7, exact_flags=False)
    # indices past the table read its last row
    idx[0, 0, 0] = rows + 5
    idx[-1, -1, 0] = 2**31 - 1
    _eb_held(t, al, be, idx, rs, w, 1e-5)


# random scales at 1e-3 and 1e-5; at 1e-7 round-off decides some clean
# bags on random scales (test_eb_kernel_matches_plain), so there only the
# dyadic scales, whose sums are exact in every order
@pytest.mark.parametrize("dyadic,rel", [(False, 1e-3), (False, 1e-5),
                                        (True, 1e-3), (True, 1e-5),
                                        (True, 1e-7)])
@pytest.mark.parametrize("tables,rows,d,bags,pool", [
    (26, 4096, 128, 10, 16), (1, 65536, 2048, 4, 1), (2, 300, 40, 5, 16)])
def test_eb_kernel_flags_under_bit_flips(rng, dev, tables, rows, d, bags,
                                         pool, dyadic, rel):
    """Each of the 8 bits of a table byte flipped (C_T left stale): flags
    and counts equal to the plain branch, on dyadic scales at every bound
    and on random scales at 1e-3 and 1e-5."""
    t, al, be, idx, rs, w = _eb_case(rng, dev, tables, rows, d, bags, pool,
                                     True, dyadic)
    tab, bag = tables - 1, bags // 2
    row, col = int(idx[tab, bag, 0]), d // 3
    caught = []
    for bit in range(8):
        t[tab, row, col] ^= -128 if bit == 7 else 1 << bit
        flags = _eb_held(t, al, be, idx, rs, w, rel)
        t[tab, row, col] ^= -128 if bit == 7 else 1 << bit
        caught.append(bool(flags[tab, bag]))
    assert caught[7]


def _hazard_case(rng, dev):
    return _eb_case(rng, dev, 26, 4096, 128, 10, 16, weighted=True)


def test_eb_pdl_after_in_place_table_flip(rng, dev):
    """K2 launched right behind the torch kernel that flips a table byte
    in place (and right behind the one that flips it back), no
    synchronisation in between: it reads the flipped byte."""
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    t, al, be, idx, rs, w = _hazard_case(rng, dev)
    row = int(idx[3, 2, 0])
    torch.cuda.synchronize()
    t[3, row, 9] ^= -128
    flipped = abft_eb_cuda(t, al, be, idx, rs, w)
    t[3, row, 9] ^= -128
    restored = abft_eb_cuda(t, al, be, idx, rs, w)
    torch.cuda.synchronize()
    assert bool(flipped[2][3, 2]) and int(flipped[3][3]) >= 1
    assert int(flipped[3].sum()) == int(flipped[3][3])
    assert not restored[2].any() and int(restored[3].sum()) == 0
    t[3, row, 9] ^= -128
    assert torch.equal(flipped[0], ref.abft_eb_slot_order_ref(t, al, be, idx,
                                                              w))


def test_eb_pdl_after_in_place_alpha_change(rng, dev):
    """K2 right behind an in-place change of a row's alpha: R uses the new
    alpha, and the check (C_T unchanged, alpha scaling both sides) stays
    clean."""
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    t, al, be, idx, rs, w = _hazard_case(rng, dev)
    row = int(idx[5, 1, 0])
    torch.cuda.synchronize()
    al[5, row] *= 4.0
    got = abft_eb_cuda(t, al, be, idx, rs, w)
    torch.cuda.synchronize()
    assert torch.equal(got[0], ref.abft_eb_slot_order_ref(t, al, be, idx, w))
    assert not got[2].any()


def test_eb_pdl_after_eb_on_same_allocation(rng, dev):
    """K2 right behind another K2 whose R and rsum were freed, so the
    allocator hands the same memory over, and on the same counters and
    tickets: flagged and clean calls in turns, queued with no
    synchronisation, each with its own flags and counts."""
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    t, al, be, idx, rs, w = _hazard_case(rng, dev)
    t_bad = t.clone()
    row = int(idx[0, 0, 0])
    t_bad[0, row, 3] ^= -128
    torch.cuda.synchronize()
    outs, ptrs = [], set()
    for tab in (t_bad, t) * 4:
        r, rsum, flags, count = abft_eb_cuda(tab, al, be, idx, rs, w)
        ptrs.add(r.data_ptr())
        outs.append((tab is t_bad, flags, count))
        del r, rsum
    last = abft_eb_cuda(t_bad, al, be, idx, rs, w)
    ptrs.add(last[0].data_ptr())
    torch.cuda.synchronize()
    assert len(ptrs) <= 2                    # the allocation was reused
    for bad, flags, count in outs + [(True, last[2], last[3])]:
        assert bool(flags[0, 0]) == bad and bool(flags.any()) == bad
        assert torch.equal(count, flags.sum(-1, dtype=torch.int32))
    assert torch.equal(last[0], ref.abft_eb_slot_order_ref(t_bad, al, be,
                                                           idx, w))


def test_eb_entry_refuses_a_plan_that_does_not_fit(rng, dev):
    """The C entry checks the launch plan it is handed (the wrapper's comes
    from eb_plan): one that does not fit returns cudaErrorInvalidValue and
    writes nothing."""
    from repro_torch.kernels import abft_embeddingbag as eb
    t, al, be, idx, rs, _ = _eb_case(rng, dev, 2, 100, 128, 5, 16)
    plan = eb.eb_plan(2, 5, 16, 128, 100, table_addr=t.data_ptr())
    r = torch.full((2, 5, 128), 7.0, device=dev)
    rsum = torch.empty((2, 5), device=dev)
    flags = torch.empty((2, 5), dtype=torch.bool, device=dev)
    count = torch.empty((2,), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for bad in (plan._replace(groups=2), plan._replace(groups=8),
                plan._replace(lanes=4), plan._replace(vec=False),
                plan._replace(blocks_per_table=1),
                plan._replace(warps_per_bag=2, bags_per_block=8)):
        rc = eb._launch()(
            t.data_ptr(), al.data_ptr(), be.data_ptr(), rs.data_ptr(),
            idx.data_ptr(), None, r.data_ptr(), rsum.data_ptr(),
            flags.data_ptr(), count.data_ptr(), eb._scratch(dev, stream, 2),
            2, 100, 128, 5, 16, 1e-5, int(bad.vec), bad.lanes, bad.groups,
            bad.warps_per_bag, bad.bags_per_block, bad.blocks_per_table,
            stream)
        assert rc == 1, bad                  # cudaErrorInvalidValue
    torch.cuda.synchronize()
    assert bool((r == 7.0).all())


def test_protected_eb_call_is_one_kernel(rng, dev):
    """A protected EmbeddingBag call on the card (the DLRM layer's route)
    launches K2 once, with the plan's rel_bound."""
    from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
    from repro_torch.protect.plan import ResolvedRule
    from repro_torch.protect.runtime import protected_call
    t, al, be, idx, rs, _ = _hazard_case(rng, dev)
    before = abft_eb_cuda.launches
    r, report = protected_call("embedding_bag", (t, al, be, rs), idx,
                               rule=ResolvedRule(rel_bound=1e-3))
    assert abft_eb_cuda.launches == before + 1
    assert int(report.as_metrics()["abft/embedding_bag_errors"]) == 0
    assert torch.equal(r, ref.abft_eb_slot_order_ref(t, al, be, idx))


def _wkv_args(rng, b, s, h, dh, dev, heavy=True):
    from repro_torch.layers.rwkv6 import LOG_W_MIN
    lo = LOG_W_MIN if heavy else -1.0
    arrs = (rng.standard_normal((b, s, h, dh)),
            rng.standard_normal((b, s, h, dh)),
            rng.standard_normal((b, s, h, dh)),
            rng.uniform(lo, 0.0, (b, s, h, dh)),
            rng.standard_normal((h, dh)) * 0.5,
            rng.standard_normal((b, h, dh, dh)) * 0.1)
    return [torch.from_numpy(a.astype(np.float32)).to(dev) for a in arrs]


@pytest.mark.parametrize("heavy", [False, True])
@pytest.mark.parametrize("b,s,h,dh,chunk", [(1, 64, 4, 16, 16),
                                            (1, 64, 32, 64, 16),
                                            (2, 64, 3, 8, 8),
                                            (3, 48, 5, 40, 16)])
def test_wkv_kernel_matches_plain(rng, dev, b, s, h, dh, chunk, heavy):
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked_cuda
    from repro_torch.layers.rwkv6 import wkv_recurrent
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _wkv_args(rng, b, s, h, dh, dev, heavy)
    before = wkv6_chunked_cuda.launches
    y, st = ops.wkv_chunked(*args, chunk=chunk)
    assert wkv6_chunked_cuda.launches == before + 1
    # the JAX tests' tolerance: the kernel sums in another order
    for want in (ref.wkv_chunked_ref(*args, chunk=chunk),
                 wkv_recurrent(*args)):
        torch.testing.assert_close(y, want[0], rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(st, want[1], rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("vec", [16, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("decay", ["heavy", "all_min"])
@pytest.mark.parametrize("b,s,h,dh,chunk", [(1, 64, 32, 64, 16),
                                            (2, 64, 8, 64, 8),
                                            (1, 64, 32, 32, 16),
                                            (2, 32, 4, 32, 8)])
def test_wkv_kernel_dtypes_and_copies(rng, dev, b, s, h, dh, chunk, decay,
                                      dtype, vec):
    """K4 on r, k, v in their own type, staged by 16- and by 4-byte copies:
    within 2e-4 of the plain version and of the recurrence; in bf16 equal,
    bit for bit, to the same launch on the float32 cast (the conversion is
    exact)."""
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked_cuda, wkv_plan
    from repro_torch.layers.rwkv6 import LOG_W_MIN, wkv_recurrent
    torch.backends.cuda.matmul.allow_tf32 = False
    args = _wkv_args(rng, b, s, h, dh, dev)
    if decay == "all_min":
        args[3] = torch.full_like(args[3], LOG_W_MIN)
    rkv = [a.to(getattr(torch, dtype)) for a in args[:3]]
    plan = wkv_plan(b, h, dh, chunk, seq=s, itemsize=rkv[0].element_size())
    assert plan.blocks == b * h * (dh // 16) and plan.vec == 16
    before = wkv6_chunked_cuda.launches
    y, st = wkv6_chunked_cuda(*rkv, *args[3:], chunk=chunk,
                              plan=plan._replace(vec=vec))
    assert wkv6_chunked_cuda.launches == before + 1
    assert y.dtype == st.dtype == torch.float32
    f32 = [t.float() for t in rkv]
    for want in (ref.wkv_chunked_ref(*rkv, *args[3:], chunk=chunk),
                 wkv_recurrent(*f32, *args[3:])):
        torch.testing.assert_close(y, want[0], rtol=2e-4, atol=2e-4)
        torch.testing.assert_close(st, want[1], rtol=2e-4, atol=2e-4)
    if dtype == "bfloat16":
        plan32 = wkv_plan(b, h, dh, chunk, seq=s)._replace(vec=vec)
        y32, st32 = wkv6_chunked_cuda(*f32, *args[3:], chunk=chunk,
                                      plan=plan32)
        assert torch.equal(y, y32) and torch.equal(st, st32)


def test_wkv_kernel_worst_case_and_limits(dev):
    from repro_torch.kernels.wkv6_chunked import wkv6_chunked_cuda
    from repro_torch.layers.rwkv6 import LOG_W_MIN, wkv_recurrent
    ones = torch.ones((1, 64, 32, 64), device=dev)
    lw = torch.full_like(ones, LOG_W_MIN)
    u, s0 = torch.ones((32, 64), device=dev), torch.ones((1, 32, 64, 64),
                                                          device=dev)
    y, st = wkv6_chunked_cuda(ones, ones, ones, lw, u, s0, chunk=16)
    assert torch.isfinite(y).all() and torch.isfinite(st).all()
    torch.testing.assert_close(y, wkv_recurrent(ones, ones, ones, lw, u,
                                                s0)[0], rtol=2e-4, atol=2e-4)
    with pytest.raises(ValueError, match="envelope"):
        wkv6_chunked_cuda(ones, ones, ones, lw, u, s0, chunk=32)
    wide = torch.ones((1, 16, 1, 80), device=dev)
    with pytest.raises(ValueError, match="head width"):
        wkv6_chunked_cuda(wide, wide, wide, wide,
                          torch.ones((1, 80), device=dev),
                          torch.ones((1, 1, 80, 80), device=dev))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv_prefill_state_feeds_decode_on_card(dev, dtype):
    """The smoke RWKV on the card (K1-K4) against the plain CPU run: the
    prefill's state (from K4) handed to 3 decode steps gives the same
    fault counters, and logits and state within 1e-4 of their scale (the
    same code on both sides; only the summation order differs)."""
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.core.policy import metrics_to_ints
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = reduce_cfg(get_arch("rwkv6-1.6b"))
    model = build_model(cfg)
    p_cpu = model.init(0, device="cpu")
    p_dev = _to(p_cpu, dev)
    ctx = Ctx(quant=True, wkv_chunk=16,
              compute_dtype=getattr(torch, dtype))
    tol = 1e-4
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    lc, cc, rc = model.prefill(p_cpu, {"tokens": tokens}, ctx)
    ld, cd, rd = model.prefill(p_dev, {"tokens": tokens.to(dev)}, ctx)
    for step in range(4):
        assert metrics_to_ints(rc.as_metrics()) == \
            metrics_to_ints(rd.as_metrics())
        scale = float(lc.float().abs().max())
        assert float((ld.float().cpu() - lc.float()).abs().max()) \
            <= tol * scale
        for k in cc:
            s_scale = float(cc[k].abs().max())
            assert float((cd[k].cpu() - cc[k]).abs().max()) <= tol * s_scale
        if step == 3:
            break
        nxt = torch.argmax(lc.float()[:, :cfg.vocab], -1).to(torch.int32)
        lc, cc, rc = model.decode(p_cpu, cc, nxt, None, ctx)
        ld, cd, rd = model.decode(p_dev, cd, nxt.to(dev), None, ctx)


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return tree.to(dev)


# the unprotected instances the overhead benchmarks time: every plan the
# paper's 28 GEMM shapes select (row tiles 16/32/64, aligned and ragged,
# 1-8 splits), A off 16-byte alignment, and n on and off a multiple of 128
@pytest.mark.parametrize("m,n,k", [
    (1, 512, 13), (20, 256, 512), (100, 128, 256), (256, 1024, 479),
    (1, 1024, 1024), (100, 1024, 1024), (256, 1024, 1024), (64, 800, 3200),
    (10, 300, 70), (65, 129, 1024)])
def test_qgemm_unprotected_equals_the_protected_c(rng, dev, m, n, k):
    from repro_torch.kernels.abft_qgemm import (abft_qgemm_cuda,
                                                 launch_plan,
                                                 qgemm_unprotected_cuda)
    a = torch.from_numpy(rng.integers(0, 256, size=(m, k))
                         .astype(np.uint8)).to(dev)
    bp = _packed(rng, k, n, dev)
    before = qgemm_unprotected_cuda.launches
    c = qgemm_unprotected_cuda(a, bp)
    assert qgemm_unprotected_cuda.launches == before + 1
    c_prot, err = abft_qgemm_cuda(a, bp)
    assert torch.equal(c, c_prot) and not bool(err.any())
    assert torch.equal(c, ref.qgemm_ref(a, bp))
    assert torch.equal(qgemm_unprotected_cuda(_misaligned(a), bp), c)
    plan = launch_plan(m, k, n, a_addr=a.data_ptr(), b_addr=bp.data_ptr(),
                       protect=False)
    assert plan.tiles_n == -(-n // 128)


def test_qgemm_unprotected_refuses_int8_a_and_a_bad_plan(rng, dev):
    import repro_torch.kernels.abft_qgemm as k1
    bp = _packed(rng, 256, 128, dev)
    with pytest.raises(TypeError):
        k1.qgemm_unprotected_cuda(torch.zeros((4, 256), dtype=torch.int8,
                                              device=dev), bp)
    # the C entry checks the plan it is handed
    a = torch.zeros((4, 256), dtype=torch.uint8, device=dev)
    c = torch.empty((4, 128), dtype=torch.int32, device=dev)
    bad = k1.launch_plan(4, 256, 128, protect=False)._replace(k_per_split=64)
    rc = k1._launch_unprotected()(
        a.data_ptr(), bp.data_ptr(), c.data_ptr(), 4, 128, 256, bp.shape[1],
        bad.bm, bad.splits, bad.k_per_split, int(bad.aligned),
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="launch failed"):
        k1._build.check(k1._NAME, rc)


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("tables,rows,d,bags,pool", [
    (1, 4000, 32, 10, 100), (1, 4000, 64, 10, 100), (1, 4000, 128, 10, 100),
    (1, 4000, 256, 10, 100), (3, 1000, 128, 10, 16), (2, 300, 48, 9, 20),
    (1, 50, 4096, 3, 5)])
def test_eb_unprotected_equals_the_protected_r(rng, dev, tables, rows, d,
                                               bags, pool, weighted):
    from repro_torch.kernels.abft_embeddingbag import (abft_eb_cuda,
                                                       eb_unprotected_cuda)
    t, al, be, idx, rs, w = _eb_case(rng, dev, tables, rows, d, bags, pool,
                                     weighted)
    before = eb_unprotected_cuda.launches
    r = eb_unprotected_cuda(t, al, be, idx, w)
    assert eb_unprotected_cuda.launches == before + 1
    assert torch.equal(r, abft_eb_cuda(t, al, be, idx, rs, w)[0])
    assert torch.equal(r, ref.abft_eb_slot_order_ref(t, al, be, idx, w))
    scale = max(1.0, float(r.abs().max()))
    assert float((r - ref.eb_ref(t, al, be, idx, w)).abs().max()) \
        <= 1e-5 * pool * scale
