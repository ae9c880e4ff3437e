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
    # the Llama-3.2-1B decode shapes at 4 slots and a prefill MLP shape
    (4, 2048, 512, "random"), (4, 8192, 2048, "random"),
    (64, 2048, 8192, "random"),
    # paged Llama prefills at its page-multiple buckets: bm 32 at m = 32,
    # a part-filled 64-row tile at m = 48
    (32, 2048, 2048, "random"), (48, 8192, 2048, "random"),
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


@pytest.fixture(scope="module")
def lm_head():
    """The Llama-3.2-1B head's packed weight, 2048 x (128256 + 128), made
    on the card (263 MB: K1's widest n on any path)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    gen = torch.Generator(device="cuda").manual_seed(19)
    b = torch.randint(-127, 128, (2048, 128256), generator=gen,
                      device="cuda", dtype=torch.int8)
    return pack_encoded_b(b)


@pytest.mark.parametrize("dtype", ["int8", "uint8"])
@pytest.mark.parametrize("m", [1, 4, 64])
def test_qgemm_kernel_at_the_llama_head(lm_head, m, dtype):
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda, launch_plan
    k, n = 2048, 128256
    plan = launch_plan(m, k, n, a_addr=0, b_addr=lm_head.data_ptr())
    assert plan.tiles_n == 1003 and plan.splits == 1 and plan.aligned
    gen = torch.Generator(device="cuda").manual_seed(m)
    lo, hi = (-128, 128) if dtype == "int8" else (0, 256)
    a = torch.randint(lo, hi, (m, k), generator=gen, device="cuda").to(
        getattr(torch, dtype))
    got = abft_qgemm_cuda(a, lm_head, with_colcheck=True)
    want = ref.abft_qgemm_ref(a, lm_head, with_colcheck=True)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert int(got[1].sum()) == 0
    # a payload bit in the last column tile, and the checksum lane
    live = (a.cpu().to(torch.int64) % 127 != 0).any(dim=0).nonzero()
    row = int(live[live >= k // 2].min())
    for lane in (n - 1, n):
        lm_head[row, lane] ^= 0x04
        try:
            g_err = abft_qgemm_cuda(a, lm_head)[1]
            assert torch.equal(g_err, ref.abft_qgemm_ref(a, lm_head)[1])
            assert int(g_err.sum()) > 0
        finally:
            lm_head[row, lane] ^= 0x04


@pytest.mark.parametrize("m,n", [(10, 13), (10, 479), (7, 12288), (300, 64)])
def test_quantize_rows_kernel_bit_exact(rng, dev, m, n):
    x = torch.from_numpy(rng.standard_normal((m, n)).astype(np.float32))
    x = x.to(dev).to(torch.bfloat16)
    for g, w in zip(ops.quantize_rows(x), ref.quantize_rows_ref(x)):
        assert torch.equal(g, w)


# the rows K3 sees on the serving paths: every DLRM layer's input
# width at the lookup batch, the RWKV projections' at prefill (64),
# decode (4) and the head in a prefill (1), the paged Llama's prefill
# buckets (48, 32) at its widths; and a ragged odd width
K3_SHAPES = ([(10, k) for k in (13, 512, 256, 479, 1024)]
             + [(m, k) for m in (64, 4, 1) for k in (2048, 7168)]
             + [(m, k) for m in (48, 32) for k in (2048, 8192)]
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


@pytest.mark.parametrize("dtype", [torch.int8, torch.uint8])
@pytest.mark.parametrize("k,n", [(13, 512), (512, 256), (479, 1024),
                                 (1024, 1024)])
def test_qgemm_repeated_calls_bit_exact(rng, dev, k, n, dtype):
    """The same DLRM-layer call (m = 10; k 479 takes the masked path)
    many times, queued without synchronisation, with and without the
    column check: every C, err_rows and column check bit-exact, so a
    race in the split-K reduce or the staging shows as a mismatch."""
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    lo, hi = (-128, 128) if dtype == torch.int8 else (0, 256)
    a = torch.from_numpy(rng.integers(lo, hi, size=(10, k))).to(dtype).to(
        dev)
    bp = _packed(rng, k, n, dev)
    for col in (False, True):
        want = ref.abft_qgemm_ref(a, bp, with_colcheck=col)
        outs = [abft_qgemm_cuda(a, bp, with_colcheck=col)
                for _ in range(256)]
        bad = [i for i, got in enumerate(outs)
               if not all(torch.equal(g, w) for g, w in zip(got, want))]
        assert not bad, f"{len(bad)} of 256 calls differ (first {bad[:4]})"


@pytest.mark.parametrize("m,k,n", [
    # hymba: k = 1600 is 12.5 of K1's 128-row stages (q/o, k/v, the SSM
    # in-projection and the MLP's gate at the prefill's 192 rows and a
    # decode step's 4), and x_proj's n = 64
    (192, 1600, 1600), (4, 1600, 320), (192, 1600, 6400), (4, 1600, 5504),
    (192, 3200, 64),
    # llava's patch projector at its 576 patches
    (576, 1024, 4096), (576, 4096, 4096)])
def test_qgemm_family_shapes_bit_exact_in_repeated_calls(rng, dev, m, k, n):
    """ROADMAP A7's new K1 shapes, 64 calls queued without a sync with
    and without the column check: every C, err_rows and column check
    bit-exact (``test_qgemm_repeated_calls_bit_exact``'s race probe)."""
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    a = torch.from_numpy(rng.integers(-128, 128, size=(m, k)).astype(
        np.int8)).to(dev)
    bp = _packed(rng, k, n, dev)
    for col in (False, True):
        want = ref.abft_qgemm_ref(a, bp, with_colcheck=col)
        outs = [abft_qgemm_cuda(a, bp, with_colcheck=col)
                for _ in range(64)]
        bad = [i for i, got in enumerate(outs)
               if not all(torch.equal(g, w) for g, w in zip(got, want))]
        assert not bad, f"{len(bad)} of 64 calls differ (first {bad[:4]})"


@pytest.mark.parametrize("arch", ["whisper-large-v3", "hymba-1.5b",
                                  "llava-next-mistral-7b", "internlm2-20b"])
def test_reduced_family_on_card_matches_the_cpu_run(dev, arch):
    """Each A7 family's reduced model on the card (K1-K3) against the
    plain CPU run on the same weights, free and in lockstep, in float32
    and bfloat16: ``chip_smoke.small_card_vs_cpu``, as phase 19 runs it
    (hymba with a third layer, whose 8-token window the 24-token prompt
    outruns)."""
    import dataclasses

    import chip_smoke
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.models.base import build_model
    from repro_torch.protect import default_plan
    torch.backends.cuda.matmul.allow_tf32 = False
    small = reduce_cfg(get_arch(arch))
    if small.family == "hybrid":
        small = dataclasses.replace(small, n_layers=3)
    model = build_model(small)
    rng = np.random.default_rng(17)
    extra = {}
    if small.patch_dim:
        extra["patches"] = torch.from_numpy(rng.standard_normal(
            (2, small.n_patches, small.patch_dim)).astype(np.float32))
    if small.family == "encdec":
        extra["frames"] = torch.from_numpy(rng.standard_normal(
            (2, small.enc_seq, small.d_model)).astype(np.float32))
    out = chip_smoke.small_card_vs_cpu(
        torch, dev, small, model, model.init(0, quant=True, device="cpu"),
        default_plan(), (24,), f32_after_split=2.0**-5, extra=extra)
    assert len(out) == 4


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
# d 128, the RWKV and Llama token tables' d 2048 at pool 1 (64 and 4 bags),
# the narrow vector widths, and ragged d (byte loads)
EB_CARD_SHAPES = [(3, 1000, 128, 10, 16), (2, 64, 40, 5, 100),
                  (1, 8, 300, 3, 2), (26, 4096, 128, 10, 16),
                  (4, 5000, 128, 300, 100), (1, 65536, 2048, 64, 1),
                  (1, 65536, 2048, 4, 1), (1, 128256, 2048, 64, 1),
                  (1, 128256, 2048, 4, 1), (2, 300, 16, 9, 33),
                  (2, 300, 32, 9, 20), (2, 300, 64, 9, 20),
                  (2, 300, 256, 9, 40), (2, 300, 48, 9, 20),
                  (1, 50, 4096, 3, 5),
                  # the token tables' widths of whisper (1280), hymba
                  # (1600), llava (4096) and internlm2 (6144: two team
                  # passes a row) at pool 1
                  (1, 51968, 1280, 64, 1), (1, 32256, 1600, 4, 1),
                  (1, 32000, 4096, 64, 1), (1, 8192, 6144, 64, 1),
                  (1, 8192, 6144, 4, 1)]


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


@pytest.mark.parametrize("rows,d,bags,pool", [
    (49408, 1536, 64, 1), (128256, 2048, 64, 1), (5000, 4096, 9, 5),
    (300, 9216, 9, 3), (51968, 1280, 64, 1), (32256, 1600, 64, 1),
    (32000, 4096, 64, 1), (8192, 6144, 64, 1)])
def test_eb_rsum_is_the_team_order_sum(rng, dev, rows, d, bags, pool):
    """On the team path (16-byte words, one bag a team of warps) K2's
    rsum is its R summed in the order ``ref.eb_rsum_team_order`` writes
    plainly, bit for bit, and its flags that sum's compare at 1e-5."""
    from repro_torch.kernels import abft_embeddingbag as eb
    t, al, be, idx, rs, w = _eb_case(rng, dev, 1, rows, d, bags, pool, True)
    plan = eb.eb_plan(1, bags, pool, d, rows, table_addr=t.data_ptr())
    assert plan.vec and plan.groups == 1
    r, rsum, flags, _ = eb.abft_eb_cuda(t, al, be, idx, rs, w)
    want = ref.eb_rsum_team_order(r, plan.warps_per_bag)
    assert torch.equal(rsum, want)
    assert torch.equal(flags, ref.eb_check_slot_order(want, al, be, idx, rs,
                                                      d, w))


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
    p_cpu = model.init(0, quant=True, device="cpu")
    p_dev = _to(p_cpu, dev)
    ctx = Ctx(quant=True, wkv_chunk=16,
              compute_dtype=getattr(torch, dtype))
    tol = 1e-4
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    lc, cc, rc = model.prefill(p_cpu, {"tokens": tokens}, ctx, 0)
    ld, cd, rd = model.prefill(p_dev, {"tokens": tokens.to(dev)}, ctx, 0)
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
    # int8 A is taken since the serving path's unprotected rung runs it;
    # a wider A is refused
    import repro_torch.kernels.abft_qgemm as k1
    bp = _packed(rng, 256, 128, dev)
    with pytest.raises(TypeError):
        k1.qgemm_unprotected_cuda(torch.zeros((4, 256), dtype=torch.int16,
                                              device=dev), bp)
    # the C entry checks the plan it is handed
    a = torch.zeros((4, 256), dtype=torch.uint8, device=dev)
    c = torch.empty((4, 128), dtype=torch.int32, device=dev)
    bad = k1.launch_plan(4, 256, 128, protect=False)._replace(k_per_split=64)
    rc = k1._launch_unprotected()(
        a.data_ptr(), 1, bp.data_ptr(), c.data_ptr(), 4, 128, 256,
        bp.shape[1], bad.bm, bad.splits, bad.k_per_split, int(bad.aligned),
        torch.cuda.current_stream().cuda_stream)
    with pytest.raises(RuntimeError, match="launch failed"):
        k1._build.check(k1._NAME, rc)


# the signed instance, the serving path's unprotected rung: bit-exact with
# the exact integer product at the Llama-3.2-1B decode and head shapes,
# granite-moe's expert shapes (decode and a 64-token prefill's capacity
# 16) and the DLRM's layers at a request's m = 10
@pytest.mark.parametrize("m,k,n", [
    (4, 2048, 2048), (64, 2048, 8192), (1, 2048, 128256),
    (4, 1536, 512), (16, 1536, 512), (4, 512, 1536), (16, 512, 1536),
    (10, 13, 512), (10, 479, 1024), (10, 256, 1)])
def test_qgemm_unprotected_int8_a_equals_int_matmul(rng, dev, m, k, n):
    from repro_torch.core import int_matmul
    from repro_torch.kernels.abft_qgemm import qgemm_unprotected_cuda
    a = torch.from_numpy(rng.integers(-128, 128, size=(m, k))
                         .astype(np.int8)).to(dev)
    bp = _packed(rng, k, n, dev)
    c = qgemm_unprotected_cuda(a, bp)
    assert torch.equal(c, int_matmul(a, bp[:, :n]))
    assert torch.equal(c, ops.qgemm_unprotected(a, bp, use_kernel=False))
    assert torch.equal(qgemm_unprotected_cuda(_misaligned(a), bp), c)


# a stack of experts: one launch an expert into one output, each held to
# the plain batched product, and the per-expert check vector
@pytest.mark.parametrize("e,m,k,n", [(40, 4, 1536, 512), (40, 16, 512, 1536),
                                     (4, 10, 64, 128)])
def test_qgemm_expert_stack_matches_plain(rng, dev, e, m, k, n):
    from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
    a = torch.from_numpy(rng.integers(-128, 128, size=(e, m, k))
                         .astype(np.int8)).to(dev)
    bp = torch.stack([_packed(rng, k, n, dev) for _ in range(e)])
    bp[e // 2, k // 3, n // 2] ^= 4                 # one expert's weight
    before = abft_qgemm_cuda.launches
    c, err = ops.abft_qgemm(a, bp)
    assert abft_qgemm_cuda.launches == before + e
    want_c, want_err = ref.abft_qgemm_ref(a.cpu(), bp.cpu())
    assert torch.equal(c.cpu(), want_c) and torch.equal(err.cpu(), want_err)
    assert int(err[e // 2].sum()) > 0 and int(err.sum()) == int(
        err[e // 2].sum())
    cu = ops.qgemm_unprotected(a, bp)
    assert torch.equal(cu.cpu(), want_c)


def test_unprotected_engine_step_runs_no_float64_gemm(dev):
    """A ``*:off`` plan on the card runs K1's and K2's unprotected
    instances: no float64 GEMM among the device operations the profiler
    counts (a float64 scalar fill of the rope's ``theta ** x`` is not a
    product)."""
    import chip_smoke
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.kernels.abft_embeddingbag import eb_unprotected_cuda
    from repro_torch.kernels.abft_qgemm import qgemm_unprotected_cuda
    from repro_torch.protect import ProtectionPlan
    from repro_torch.serving import Request, ServingEngine, TenantSpec
    for arch in ("llama3.2-1b", "granite-moe-3b-a800m"):
        eng = ServingEngine(reduce_cfg(get_arch(arch)), [TenantSpec(
            "t", ProtectionPlan.parse("*:off", name="off"))], n_slots=2,
            max_prompt=16, max_new_tokens=3, device=dev)
        reqs = [Request(rid=i, tenant="t", arrival_s=0.0, prompt_len=12,
                        max_new_tokens=3, seed=i) for i in range(2)]
        eng.run(reqs)
        q0, e0 = qgemm_unprotected_cuda.launches, eb_unprotected_cuda.launches

        def serve():
            eng.reset_state()
            eng.run(reqs, warmup=False)
        ops_seen = chip_smoke.device_ops(torch, serve)
        assert qgemm_unprotected_cuda.launches > q0
        assert eb_unprotected_cuda.launches > e0
        gemms = [name for name, _ in ops_seen if "gemm" in name.lower()]
        assert not [n for n in gemms if "dgemm" in n.lower() or any(
            s in n.lower() for s in ("f64", "double"))], gemms


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


# ------------------------- the paged KV cache -------------------------------

@pytest.mark.parametrize("kv,p,dh,n_pages,n_slots,max_pages,layers", [
    (2, 4, 16, 10, 3, 5, 2),
    # full-width Llama-3.2-1B at page 16 (phase 14 of chip_smoke.py)
    (8, 16, 64, 26, 4, 6, 16)])
def test_paged_cache_on_card_matches_the_cpu_run(rng, dev, kv, p, dh,
                                                 n_pages, n_slots,
                                                 max_pages, layers):
    """The paged cache functions on the card against the same calls on
    the CPU: codes, affine parameters, pagesums, mismatch counts and
    pages verified bit-exact; the attention within 1e-5 of its scale."""
    from repro_torch import paging as tp

    def run(device):
        g = np.random.default_rng(7)
        pools = {name: tp.paged_pool(n_pages, kv, p, dh, n_slots,
                                     max_pages, n_layers=layers,
                                     device=device) for name in "kv"}
        table = np.full((n_slots, max_pages), -1, np.int32)
        table[0, :3] = [3, 1, 4]                    # slot 0: 2 prompt pages
        table[1, :3] = [3, 5, 6]                    # + tail; shares page 3
        for name, pool in pools.items():
            for ids in ([3, 1], [n_pages, 5]):      # page 3 packed once
                src = torch.from_numpy(g.standard_normal(
                    (layers, 1, kv, 2 * p, dh)).astype(np.float32))
                tp.pack_prompt_pages(pool, src.to(device),
                                     np.asarray(ids, np.int32))
            tp.reset_pages(pool, np.asarray([4, 6, n_pages], np.int32))
            pools[name] = pool._replace(table=torch.from_numpy(
                table).to(device).expand((layers,) + table.shape))
        pos = torch.tensor([2 * p, 2 * p] + [0] * (n_slots - 2),
                           dtype=torch.int32, device=device)
        outs = []
        for step in range(3):
            layer = {k: tp.PagedKV(*(x[step % layers] for x in v))
                     for k, v in pools.items()}
            new = torch.from_numpy(g.standard_normal(
                (n_slots, kv, dh)).astype(np.float32)).to(device)
            for name in "kv":
                tp.paged_append(layer[name], pos, new * (2 if name == "v"
                                                         else 1))
            q = torch.from_numpy(g.standard_normal(
                (n_slots, 4 * kv, dh)).astype(np.float32)).to(device)
            outs.append(tp.attend_paged(q, layer["k"], layer["v"], pos,
                                        n_heads=4 * kv, n_kv=kv))
            pos = pos + 1
        pools["k"].q[1, 3, 0, 2, 5] ^= 16            # a shared prompt page
        flags = tp.scrub_cache({"attn": pools}, pos)
        return pools, outs, flags

    cpu, card = run("cpu"), run(dev)
    for name in "kv":
        for f in tp.PagedKV._fields:
            assert torch.equal(getattr(card[0][name], f).cpu(),
                               getattr(cpu[0][name], f)), (name, f)
    for (o_card, e_card, n_card), (o_cpu, e_cpu, n_cpu) in zip(card[1],
                                                                cpu[1]):
        assert int(e_card) == int(e_cpu) == 0
        assert int(n_card) == int(n_cpu) > 0
        scale = float(o_cpu.abs().max())
        assert float((o_card.cpu() - o_cpu).abs().max()) <= 1e-5 * scale
    for name in "kv":
        assert torch.equal(card[2][name].cpu(), cpu[2][name])
    assert int(cpu[2]["k"].sum()) == 2                # both sharing slots


def _monitored_serve(device, params):
    """The reduced Llama on ``device`` under ``*:policy=log,
    embedding_bag:threshold=adaptive`` with a Monitor and an FP-budget
    controller, every arrival at t = 0 and ``mlp.down`` flips at steps
    4, 5 and 6: (per-step counters, untimed events, monitor and
    controller summaries, the lane's final plan)."""
    import dataclasses as dc

    from repro_torch.adapt import AdaptiveThresholds, ControllerConfig
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.obs import Monitor, Observability
    from repro_torch.protect import ProtectionPlan
    from repro_torch.serving import (FaultInjection, ServingEngine,
                                     TenantSpec, chat_stream)
    eng = ServingEngine(reduce_cfg(get_arch("llama3.2-1b")), [TenantSpec(
        "t", ProtectionPlan.parse(
            "*:policy=log,embedding_bag:threshold=adaptive", name="t"))],
        n_slots=2, max_prompt=8, max_new_tokens=4, seed=0, device=device)
    eng.params = _to(params, eng.device)
    stream = [dc.replace(r, arrival_s=0.0) for r in chat_stream(
        24, tenants={"t": 1.0}, rate_rps=500.0, seed=3, mean_prompt=6,
        max_prompt=8, mean_output=3, max_output=4)]
    obs, mon = Observability.create(), Monitor()
    ad = AdaptiveThresholds(config=ControllerConfig(
        fp_budget=0.5, hysteresis=1.0, min_checks=2, cooldown_ticks=2,
        settle_ticks=3, floor=1e-6, window_ticks=8))
    tel = eng.run(stream, obs=obs, monitor=mon, adapt=ad, inject=[
        FaultInjection(step=s, victim="mlp.down", seed=i)
        for i, s in enumerate((4, 5, 6))])
    events = []
    for e in obs.bus:
        d = e.to_dict()
        d.pop("t_s")
        d["attrs"].pop("duration_ms", None)
        events.append(d)
    ms = mon.summary()
    for a in ms["alerts"] + ms["active_alerts"]:
        a.pop("t_s"), a.pop("resolved_t_s")
    for t in ms["transitions"]:
        t.pop("t_s")
    return ([(e.step, e.kind, e.slot_rids, e.counters) for e in tel.steps],
            events, ms, ad.summary(),
            (eng._lane_of["t"].plan.name, eng._lane_of["t"].plan.describe()))


def _eb_round_off_case(table, alphas, betas, idx, rel_bound) -> bool:
    """Whether a one-table bag's Eq. (5) flag is within float32 round-off
    of its bound: | |sum of its float64 terms - csum| - tol | is at most
    (d + 2) u times the terms' magnitude, so the summation order decides
    it."""
    d = table.shape[-1]
    rows = idx[idx >= 0].long()
    a, b = alphas[rows].double(), betas[rows].double()
    terms = a[:, None] * table[rows].double() + b[:, None]
    ct = table[rows].sum(-1, dtype=torch.int64).double()
    csum = (a * ct + d * b).sum()
    mag = (a.abs() * ct.abs() + d * b.abs()).sum()
    tol = rel_bound * max(float(mag), 1.0)
    reach = (d + 2) * 2.0**-24 * float(terms.abs().sum() + csum.abs())
    return abs(abs(float(terms.sum() - csum)) - tol) <= reach


def test_monitored_adaptive_engine_on_card_counts_as_on_the_cpu(
        dev, monkeypatch):
    """An engine on the card with ``monitor=`` and ``adapt=`` against the
    same engine and weights on the CPU, step for step: every counter,
    every event (times aside), the health walk to quarantine and back,
    the controller's moves and the lane's escalated plan are equal.

    The token table is the model's own, from seed 0, and the controller
    tightens to its floor 1e-6, where clean bags flag.  There the order
    of K2's sums and the plain branch's decides a flag within float32
    round-off of the bound (ROADMAP §C2, §C6): the CPU engine takes each
    EmbeddingBag call's flags from the card's same call, and every flag
    where the two differ must be such a round-off case."""
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.kernels import ops as kops
    from repro_torch.models.base import build_model
    params = build_model(reduce_cfg(get_arch("llama3.2-1b"))).init(
        0, quant=True, device="cpu")
    real = kops.abft_embedding_bag
    calls = []

    # the LM's lookups are one-table calls (which call the stacked form)
    def recording(table_q, alphas, betas, indices, *args, **kw):
        out = real(table_q, alphas, betas, indices, *args, **kw)
        if indices.dim() == 2:
            calls.append((indices.cpu(), out.err_bags.cpu(),
                          kw["rel_bound"]))
        return out

    def replaying(table_q, alphas, betas, indices, *args, **kw):
        out = real(table_q, alphas, betas, indices, *args, **kw)
        if indices.dim() != 2:
            return out
        idx, err, bound = calls.pop(0)
        assert torch.equal(idx, indices) and bound == kw["rel_bound"]
        for bag in torch.nonzero(err != out.err_bags).flatten().tolist():
            assert _eb_round_off_case(table_q, alphas, betas, idx[bag],
                                      bound), (bag, bound)
        return out._replace(err_bags=err, err_count=err.sum(
            dtype=torch.int32))

    monkeypatch.setattr(kops, "abft_embedding_bag", recording)
    card = _monitored_serve(dev, params)
    monkeypatch.setattr(kops, "abft_embedding_bag", replaying)
    cpu = _monitored_serve("cpu", params)
    assert not calls
    for name, a, b in zip(("steps", "events", "monitor", "controllers",
                           "plan"), card, cpu):
        if isinstance(a, list):
            diff = [(i, x, y) for i, (x, y) in enumerate(zip(a, b))
                    if x != y][:2]
            assert len(a) == len(b) and not diff, (name, len(a), len(b),
                                                  diff)
        assert a == b, name
    steps, events, ms, ctrls, plan = card
    # to quarantine and out of it (clean flags at the floor may keep the
    # tenant degraded at the end)
    assert any(t["new"] == "quarantined" for t in ms["transitions"])
    assert any(t["old"] == "quarantined" for t in ms["transitions"])
    assert ctrls[0]["adjustments"] >= 1 and plan[0] == "t+escalated"


@pytest.mark.parametrize("drift", ["variance_shift", "bursty"])
def test_adaptive_grid_cell_on_card_equals_cpu(dev, drift):
    """``--grid adaptive``'s ratio stream takes JAX's draws and one fixed
    order of float32 adds: a cell on the card counts, moves and converges
    exactly as on the CPU."""
    from repro_torch.campaign import adaptive as grid
    spec = grid.quick_adaptive_spec(0)
    plan = next(p for p in grid.adaptive_plans(spec) if p.drift == drift)
    card, cpu = (grid.run_adaptive_cell(plan, config=spec.controller_config(),
                                        device=d)["metrics"].to_dict()
                 for d in (dev, "cpu"))
    assert card == cpu


@pytest.mark.parametrize("dyadic", [False, True])
def test_eb_flags_after_a_bound_move_equal_a_fresh_call(rng, dev, dyadic):
    """A controller's bound move rewrites the plan and K2 takes the new
    ``rel_bound`` as a launch argument: the protected call under the
    moved plan flags exactly what a fresh K2 call at that bound flags
    (and, on dyadic scales, the plain branch), with no state kept from
    the call at the old bound."""
    from repro_torch.layers.common import Ctx
    from repro_torch.protect import OpRule, ProtectionPlan, protected_call
    t, al, be, idx, rs, w = _eb_case(rng, dev, 1, 4096, 128, 64, 16,
                                     False, dyadic)
    t[0, int(idx[0, 3, 0]), 7] ^= 4                  # a low-bit flip
    plan = ProtectionPlan.parse("*:policy=log,embedding_bag:threshold="
                                "adaptive,embedding_bag:rel_bound=1e-5")
    enc = (t, al, be, rs)
    _, rep0 = protected_call("embedding_bag", enc, idx, w,
                             ctx=Ctx(quant=True, plan=plan))
    for bound in (1e-3, 3e-6, 1e-7, 1.35e-5):
        moved = plan.with_rules(OpRule(pattern="embedding_bag",
                                       rel_bound=bound))
        assert moved.resolve("embedding_bag").rel_bound == bound
        _, rep = protected_call("embedding_bag", enc, idx, w,
                                ctx=Ctx(quant=True, plan=moved))
        fresh = ops.abft_embedding_bag(t, al, be, idx, rs, w,
                                       rel_bound=bound)
        assert int(rep.errors["embedding_bag"]) == int(fresh.err_count)
        if dyadic:
            plain = ops.abft_embedding_bag(t, al, be, idx, rs, w,
                                           rel_bound=bound,
                                           use_kernel=False)
            assert torch.equal(fresh.err_bags, plain.err_bags)
    assert int(rep0.errors["embedding_bag"]) == int(
        ops.abft_embedding_bag(t, al, be, idx, rs, w,
                               rel_bound=1e-5).err_count)


# ------------------------- training (ROADMAP A6) ----------------------------

def _train_setup(dev_name):
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.launch.steps import init_train_state, make_train_step
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.models.convert import to_device
    model = build_model(reduce_cfg(get_arch("llama3.2-1b")))
    state = to_device(init_train_state(model, 0, compress=True,
                                       device="cpu"), dev_name)
    step = make_train_step(model, Ctx(quant=False,
                                      compute_dtype=torch.float32),
                           accum=2, peak_lr=1e-2, warmup=0, total_steps=10,
                           compress=True)
    rng = np.random.default_rng(0)
    toks = rng.integers(0, model.cfg.vocab, (4, 17)).astype(np.int32)
    batch = {"tokens": torch.from_numpy(toks[:, :-1]).to(dev_name),
             "labels": torch.from_numpy(toks[:, 1:]).to(dev_name)}
    return model, state, step, batch


def test_cuda_sqrt_is_correctly_rounded(dev):
    """AdamW's square root on the card is the IEEE one, as XLA's (on the
    CPU the port takes it in float64: ``optim.adamw.ieee_sqrt``)."""
    from repro_torch.optim.adamw import ieee_sqrt
    rng = np.random.default_rng(0)
    x = np.concatenate([np.abs(rng.standard_normal(500_000)),
                        10.0 ** rng.uniform(-30, 30, 500_000)]
                       ).astype(np.float32)
    got = ieee_sqrt(torch.from_numpy(x).to(dev)).cpu().numpy()
    np.testing.assert_array_equal(got, np.sqrt(x))


def test_train_step_on_card_within_tolerance_of_the_cpu(dev):
    """The reduced Llama's loss and gradients on the card against the CPU
    run (the attention's bf16 cotangents: 2^-7 of each leaf's largest
    magnitude, ROADMAP §C10), and a full step (2 microbatches, the
    checked compression, AdamW) with 0 comm errors on both."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.device import deterministic
    from repro_torch.launch.steps import make_grad_fn
    from repro_torch.layers.common import Ctx
    model, s_cpu, step, b_cpu = _train_setup("cpu")
    _, s_dev, _, b_dev = _train_setup(dev)
    grad = make_grad_fn(model, Ctx(quant=False,
                                   compute_dtype=torch.float32))
    with deterministic():
        (l_c, _), g_c = grad(s_cpu["params"], b_cpu)
        (l_d, _), g_d = grad(s_dev["params"], b_dev)
        n_c, m_c = step(s_cpu, b_cpu)
        n_d, m_d = step(s_dev, b_dev)
    assert abs(float(l_d) - float(l_c)) <= 1e-5 * abs(float(l_c))
    for a, b in zip(tree_leaves(g_c), tree_leaves(g_d)):
        scale = float(a.abs().max()) or 1.0
        assert float((a - b.cpu()).abs().max()) <= 2 ** -7 * scale
    assert int(m_c["comm/errors"]) == int(m_d["comm/errors"]) == 0
    assert abs(float(m_d["loss_final"]) - float(m_c["loss_final"])) <= \
        1e-5 * abs(float(m_c["loss_final"]))
    for a, b in zip(tree_leaves(n_c["params"]), tree_leaves(n_d["params"])):
        # a first Adam step is lr·sign(g): equal but where a gradient
        # near 0 (or its int8 code) splits between the devices
        diff = (a - b.cpu()).abs()
        assert float(diff.max()) <= 2.5e-2
        assert float((diff > 1e-6).to(torch.float32).mean()) <= 0.01


def test_train_steps_deterministic_on_card(dev):
    """Three steps twice from one state under deterministic algorithms:
    every leaf of the final state bit-equal (the clean twin's premise)."""
    from repro_torch.core.tree import tree_leaves
    from repro_torch.device import deterministic
    _, state, step, batch = _train_setup(dev)
    finals = []
    for _ in range(2):
        s = state
        with deterministic():
            for _ in range(3):
                s, _m = step(s, batch)
        finals.append(s)
    for a, b in zip(tree_leaves(finals[0]), tree_leaves(finals[1])):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell_id", [
    "train_payload/bitflip/significant/2x16/int8",
    "train_grad_pre/bitflip/significant/2x16/float32"])
def test_training_cell_on_card_equals_cpu(dev, cell_id):
    """One training cell on the card and on the CPU, trial for trial:
    the same draws (JAX's stream), the same weights (made on the CPU from
    the cell's key), the same detections and corruptions."""
    from repro_torch.campaign.executor import run_cell
    from repro_torch.campaign.grids import training_specs
    from repro_torch.campaign.spec import expand
    plan = {p.cell_id: p for s in training_specs(0, quick=True)
            for p in expand(s)[0]}[cell_id]
    card = run_cell(plan, device=dev)
    cpu = run_cell(plan, device="cpu")
    assert torch.equal(card.trials, cpu.trials)
    assert torch.equal(card.clean, cpu.clean)
    assert card.metrics.detected == cpu.metrics.detected


# ------------------- training of the other families (A7) --------------------

FAMILIES_TRAINED = ["granite-moe-3b-a800m", "rwkv6-1.6b",
                    "whisper-large-v3", "hymba-1.5b",
                    "llava-next-mistral-7b"]


def _family_batch(cfg, dev_name, b=4, s=16):
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (b, s + 1)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.patch_dim:
        batch["patches"] = rng.standard_normal(
            (b, cfg.n_patches, cfg.patch_dim)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev_name) for k, v in batch.items()}


@pytest.mark.parametrize("arch", FAMILIES_TRAINED)
def test_family_train_step_on_card_within_tolerance_of_the_cpu(dev, arch):
    """One training step of the family's reduced model on the card
    against the CPU run, float32 compute: the loss and each gradient
    leaf within :mod:`repro_torch.launch.parity`'s tolerances, card
    against CPU; the step (2 microbatches, the checked compression,
    AdamW) with 0 comm errors on both and its loss within the loss's
    tolerance."""
    from repro_torch.configs import get_arch, reduce_cfg
    from repro_torch.core.inject import leaf_paths
    from repro_torch.device import deterministic
    from repro_torch.launch.parity import (grad_scale, grad_tolerance,
                                           loss_tolerance)
    from repro_torch.launch.steps import (init_train_state, make_grad_fn,
                                          make_train_step)
    from repro_torch.layers.common import Ctx
    from repro_torch.models.base import build_model
    from repro_torch.models.convert import to_device
    cfg = reduce_cfg(get_arch(arch))
    model = build_model(cfg, max_pos=64)
    ctx = Ctx(quant=False, compute_dtype=torch.float32)
    s_cpu = init_train_state(model, 0, compress=True, device="cpu")
    s_dev = to_device(s_cpu, dev)
    b_cpu, b_dev = _family_batch(cfg, "cpu"), _family_batch(cfg, dev)
    grad = make_grad_fn(model, ctx)
    step = make_train_step(model, ctx, accum=2, peak_lr=1e-3, warmup=0,
                           total_steps=10, compress=True)
    with deterministic():
        (l_c, _), g_c = grad(s_cpu["params"], b_cpu)
        (l_d, _), g_d = grad(s_dev["params"], b_dev)
        _, m_c = step(s_cpu, b_cpu)
        _, m_d = step(s_dev, b_dev)
    loss_tol = loss_tolerance(cfg, "float32", card=True)
    assert abs(float(l_d) - float(l_c)) <= loss_tol * abs(float(l_c))
    tol = grad_tolerance(cfg, "float32")
    named = dict(leaf_paths(g_c))
    for (path, a), (_, b) in zip(leaf_paths(g_c), leaf_paths(g_d)):
        scale = grad_scale(path, named)
        assert float((a - b.cpu()).abs().max()) <= tol * scale, path
    assert int(m_c["comm/errors"]) == int(m_d["comm/errors"]) == 0
    assert abs(float(m_d["loss_final"]) - float(m_c["loss_final"])) <= \
        loss_tol * abs(float(m_c["loss_final"]))


def test_linear_scan_graph_equals_the_eager_loop(dev):
    """A training step's scan replays its token loops from the step's
    CUDA graphs: the same kernels on the same operands, so its output
    and gradients equal the loop run eagerly on the card bit for bit
    (and the CPU's within float32 round-off)."""
    from repro_torch.layers import scan
    rng = np.random.default_rng(3)
    a, b = (torch.from_numpy(rng.uniform(0.2, 1.0, (2, 40, 6, 5)).astype(
        np.float32)), torch.from_numpy(rng.standard_normal(
            (2, 40, 6, 5)).astype(np.float32)))
    h0 = torch.from_numpy(rng.standard_normal((2, 6, 5)).astype(np.float32))
    ct = torch.from_numpy(rng.standard_normal((2, 40, 6, 5)).astype(
        np.float32))
    runs = []
    graphs = scan.ScanGraphs()
    for device, cache in ((dev, graphs), (dev, None), ("cpu", None)):
        ts = [t.to(device).requires_grad_() for t in (a, b, h0)]
        out = scan.linear_scan(*ts, graphs=cache)
        (out * ct.to(device)).sum().backward()
        runs.append([out.detach().cpu()] + [t.grad.cpu() for t in ts])
    # the forward and the backward loop were captured
    assert len(graphs._graphs) == 2
    for x, y in zip(runs[0], runs[1]):
        assert torch.equal(x, y)
    for x, y in zip(runs[0], runs[2]):
        assert float((x - y).abs().max()) <= 1e-6 * float(y.abs().max())
