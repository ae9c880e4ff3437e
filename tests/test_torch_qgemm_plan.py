"""K1's launch plan (``kernels/abft_qgemm.launch_plan``) at every GEMM shape
of the port's three serving paths (DLRM, RWKV6-1.6B, Llama-3.2-1B).

The plan is made on the host, so it is checked here on the CPU: the
splits cover k in whole pipeline stages with no overlap, the split is
the largest allowed cluster (at most 8 blocks) that keeps the grid to
one wave of blocks on the H100's 132 SMs, every RWKV shape fills at
least three quarters of them, and the TMA path is taken only where
pointers and strides are 16-byte multiples (the ragged DLRM shapes take
the masked path).
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.dlrm import EXTRAS  # noqa: E402
from repro_torch.core import LANE  # noqa: E402
from repro_torch.kernels import abft_qgemm as qg  # noqa: E402
from repro_torch.models.dlrm import init_dlrm  # noqa: E402

_RWKV = get_arch("rwkv6-1.6b")
_D, _FF, _V = _RWKV.d_model, _RWKV.d_ff, _RWKV.vocab


def _dlrm_shapes():
    """(k, n) of every DLRM layer, read from the model's own packed
    weights (full-width MLPs; the tables cut to 8 rows)."""
    p = init_dlrm(0, dataclasses.replace(EXTRAS, table_rows=8),
                  device="cpu")
    return [(w["w_packed"].shape[0], w["w_packed"].shape[1] - LANE)
            for w in p["bottom"] + p["top"]]


DLRM_SHAPES = _dlrm_shapes()
DLRM_CASES = [(EXTRAS.batch, k, n) for k, n in DLRM_SHAPES] + [
    (2048, 1024, 1024)]                  # the paper's Fig.-5 GEMM shape
# (m, k, n): prefill m = 64 and decode m = 4 on the layer projections,
# the head at m = 1 in a prefill and m = 4 in decode
RWKV_CASES = [(m, k, n) for k, n in ((_D, _D), (_D, _FF), (_FF, _D))
              for m in (64, 4)] + [(1, _D, _V), (4, _D, _V)]
_LLAMA = get_arch("llama3.2-1b")
_LD, _LKV = _LLAMA.d_model, _LLAMA.n_kv_heads * _LLAMA.head_dim_
_LFF, _LV = _LLAMA.d_ff, _LLAMA.vocab_padded
# the Llama projections at prefill m = 64 and decode m = 4, the head at
# m = 1 (a prefill's last position) and m = 4 (decode)
LLAMA_CASES = [(m, k, n) for k, n in ((_LD, _LD), (_LD, _LKV), (_LD, _LFF),
                                      (_LFF, _LD))
               for m in (64, 4)] + [(1, _LD, _LV), (4, _LD, _LV)]
ALL_CASES = DLRM_CASES + RWKV_CASES + LLAMA_CASES


def _id(case):
    return "m{}_k{}_n{}".format(*case)


def test_the_paths_have_the_expected_shapes():
    assert DLRM_SHAPES == [(13, 512), (512, 256), (256, 128), (479, 1024),
                           (1024, 1024), (1024, 512), (512, 256), (256, 1)]
    assert (_D, _FF, _V) == (2048, 7168, 65536)
    assert (_LD, _LKV, _LFF, _LV) == (2048, 512, 8192, 128256)


@pytest.mark.parametrize("m", [1, 4, 64])
def test_the_llama_head_runs_unsplit_over_its_1003_column_tiles(m):
    """K1's widest n on any path: 2048 x 128256, B' 263 MB.  Its column
    tiles alone are 7.6 waves of the card, so K is not split; the row
    verify adds 1003 tiles' partials into each row's sum, and the last
    of the 1003 blocks sets the flags."""
    plan = qg.launch_plan(m, _LD, _LV)
    assert plan.splits == 1 and plan.k_per_split == _LD
    assert plan.tiles_n == 1003 and plan.blocks == 1003 and plan.aligned
    assert plan.tiles_m == 1
    # byte offsets into B' and C stay inside int32
    assert _LD * (_LV + LANE) < 2**31 and 64 * _LV < 2**31
    # the mod-127 row partials: 1003 tiles of at most 128 x 126 each
    assert plan.tiles_n * qg.BN * 126 < 2**31


@pytest.mark.parametrize("case", ALL_CASES, ids=_id)
def test_splits_cover_k_in_whole_stages(case):
    m, k, n = case
    plan = qg.launch_plan(m, k, n)
    assert plan.k_per_split % qg.BK == 0
    ranges = plan.k_ranges(k)
    assert len(ranges) == plan.splits
    assert ranges[0][0] == 0 and ranges[-1][1] == k
    for (lo, hi), (lo2, _) in zip(ranges, ranges[1:]):
        assert hi == lo2                          # no gap, no overlap
        assert (hi - lo) % qg.BK == 0             # inner splits: whole stages
    assert all(hi > lo for lo, hi in ranges)      # no split left empty


@pytest.mark.parametrize("case", ALL_CASES, ids=_id)
def test_tiles_cover_the_output_and_the_checksum_column(case):
    m, k, n = case
    plan = qg.launch_plan(m, k, n)
    assert plan.bm in (16, 32, 64) and plan.bm >= min(m, 64)
    assert (plan.tiles_m - 1) * plan.bm < m <= plan.tiles_m * plan.bm
    assert (plan.tiles_n - 1) * qg.BN < n + 1 <= plan.tiles_n * qg.BN
    assert plan.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("case", RWKV_CASES, ids=_id)
def test_every_rwkv_shape_fills_most_of_the_card(case):
    plan = qg.launch_plan(*case)
    assert plan.blocks >= 3 * qg.SMS // 4
    assert plan.tiles_m == 1                      # m <= 64: one row tile
    assert plan.aligned


@pytest.mark.parametrize("case", ALL_CASES, ids=_id)
def test_split_is_the_largest_cluster_of_one_wave(case):
    m, k, n = case
    plan = qg.launch_plan(m, k, n)
    tiles = plan.tiles_m * plan.tiles_n
    assert plan.splits in qg.CLUSTER_SIZES
    assert 1 <= plan.splits <= 8                # portable cluster size
    assert plan.splits == 1 or plan.blocks <= qg.SMS      # one wave
    ksteps = -(-k // qg.BK)
    for larger in qg.CLUSTER_SIZES:
        if larger <= plan.splits or larger > ksteps:
            continue
        even = -(-ksteps // -(-ksteps // larger)) == larger
        assert tiles * larger > qg.SMS or not even


@pytest.mark.parametrize("a_off,b_off", [(0, 0), (1, 0), (0, 8), (16, 32)])
@pytest.mark.parametrize("case", ALL_CASES, ids=_id)
def test_aligned_path_only_on_16_byte_multiples(case, a_off, b_off):
    m, k, n = case
    plan = qg.launch_plan(m, k, n, a_addr=4096 + a_off, b_addr=8192 + b_off)
    ok = a_off % 16 == 0 and b_off % 16 == 0 and k % 16 == 0 and \
        (n + LANE) % 16 == 0
    assert plan.aligned == ok


@pytest.mark.parametrize("case", [c for c in DLRM_CASES
                                  if c[1] % 16 or (c[2] + LANE) % 16],
                         ids=_id)
def test_ragged_dlrm_shapes_take_the_masked_path(case):
    assert not qg.launch_plan(*case).aligned


def test_the_ragged_dlrm_shapes_are_the_expected_ones():
    ragged = [(k, n) for _, k, n in DLRM_CASES
              if not qg.launch_plan(EXTRAS.batch, k, n).aligned]
    assert ragged == [(13, 512), (479, 1024), (256, 1)]


@pytest.mark.parametrize("m,k,n", [(1, 2**16 + 1, 8), (65535 * 64 + 1, 16, 8),
                                   (0, 16, 8), (4, 0, 8), (4, 16, 0)])
def test_unsupported_shapes_raise(m, k, n):
    with pytest.raises(ValueError):
        qg.launch_plan(m, k, n)
