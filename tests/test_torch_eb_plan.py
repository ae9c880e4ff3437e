"""K2's launch plan (``kernels/abft_embeddingbag.eb_plan``) at every
EmbeddingBag shape of the port's two serving paths and at the ragged
widths.

The plan is made on the host, so it is checked here on the CPU: a row's
lanes times the word cover d exactly, 16-byte words are taken only where
d is a multiple of 16 and the table is 16-byte aligned, a warp load's
lane groups fit one warp, the grid is within CUDA's limits, the bytes in
flight per SM reach the design's figure at the paper's Table I pooling,
and a request's every slot is in flight in the first round.
"""
import math

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.configs.dlrm import EXTRAS  # noqa: E402
from repro_torch.kernels import abft_embeddingbag as eb  # noqa: E402

_RWKV = get_arch("rwkv6-1.6b")
_T, _ROWS, _D = EXTRAS.n_tables, EXTRAS.table_rows, EXTRAS.emb_dim

# (tables, bags, pool, d, rows)
REQUEST = (_T, EXTRAS.batch, 16, _D, _ROWS)        # one DLRM request
TABLE_I = (_T, 2048, 100, _D, _ROWS)               # the paper's Table I
RWKV_PREFILL = (1, 64, 1, _RWKV.d_model, _RWKV.vocab)
RWKV_DECODE = (1, 4, 1, _RWKV.d_model, _RWKV.vocab)
RAGGED = [(2, 5, 100, 40, 64), (1, 3, 2, 300, 8)]
SMALL = [(4, 10, 16, 32, 512), (3, 10, 16, 16, 1000), (2, 7, 33, 256, 50),
         (2, 7, 9, 48, 50), (1, 3, 5, 4096, 20), (1, 2, 3, 8192, 20)]
ALL = [REQUEST, TABLE_I, RWKV_PREFILL, RWKV_DECODE] + RAGGED + SMALL


def _id(case):
    return "t{}_b{}_p{}_d{}_r{}".format(*case)


@pytest.mark.parametrize("case", ALL, ids=_id)
def test_plan_covers_the_row(case):
    tables, bags, pool, d, rows = case
    p = eb.eb_plan(tables, bags, pool, d, rows)
    assert p.lanes * p.word == d
    assert p.vec == (d % 16 == 0)
    # a warp load brings 4 slots exactly where a row is 1, 2, 4 or 8 words
    assert (p.groups == 4) == (p.vec and p.lanes in (1, 2, 4, 8))
    if p.groups > 1:
        # one warp a bag; each lane ends with 16 / groups whole columns
        assert p.warps_per_bag == 1
        assert p.lanes * p.groups <= 32 and 32 % p.lanes == 0
    else:
        assert p.groups == 1
        # a team of warps walks the row in steps of its lanes
        assert 1 <= p.warps_per_bag <= 8
        assert p.warps_per_bag == min(8, math.ceil(p.lanes / 32))


@pytest.mark.parametrize("case", ALL, ids=_id)
def test_plan_grid_within_limits(case):
    tables, bags, pool, d, rows = case
    p = eb.eb_plan(tables, bags, pool, d, rows)
    assert 32 <= p.threads <= eb.MAX_THREADS and p.threads % 32 == 0
    assert p.blocks_per_table == math.ceil(bags / p.bags_per_block)
    assert p.blocks == tables * p.blocks_per_table < 2**31
    # every bag has its team, and no block holds bags of two tables
    assert p.blocks_per_table * p.bags_per_block >= bags
    assert (p.blocks_per_table - 1) * p.bags_per_block < bags
    # blocks as large as allowed while the grid still covers the SMs
    if p.bags_per_block > 1:
        assert p.blocks >= eb.SMS


@pytest.mark.parametrize("addr", [1, 4, 8])
def test_vector_path_needs_an_aligned_table(addr):
    p = eb.eb_plan(*REQUEST, table_addr=addr)
    assert not p.vec and p.lanes == _D and p.groups == 1
    assert eb.eb_plan(*REQUEST, table_addr=256).vec


def test_plan_at_the_serving_shapes():
    # d 128: 8 lanes a row, 4 slots a warp load, a warp a bag
    req = eb.eb_plan(*REQUEST)
    assert (req.lanes, req.groups, req.warps_per_bag) == (8, 4, 1)
    # 260 bags: one a block, so the request spreads over every SM
    assert req.bags_per_block == 1 and req.blocks == _T * EXTRAS.batch
    big = eb.eb_plan(*TABLE_I)
    assert (big.lanes, big.groups, big.bags_per_block) == (8, 4, 8)
    assert big.blocks == _T * 2048 // 8
    # d 2048: 128 lanes, a team of 4 warps, one slot a load
    for case in (RWKV_PREFILL, RWKV_DECODE):
        p = eb.eb_plan(*case)
        assert (p.lanes, p.groups, p.warps_per_bag) == (128, 1, 4)
        assert p.bags_per_block == 1 and p.blocks == case[1]


def test_bytes_in_flight():
    # Table I: the design's figure per SM (Little's law at HBM's rate)
    big = eb.eb_plan(*TABLE_I)
    assert big.inflight_bytes_per_sm(100) >= eb.INFLIGHT_TARGET
    assert big.inflight_bytes_per_sm(100) == 24 * 32 * 8 * 16
    # a request: every slot's row is issued in the first round
    req = eb.eb_plan(*REQUEST)
    assert eb.INFLIGHT * req.groups >= REQUEST[2]
    assert req.inflight_bytes_per_sm(16) == 2 * 32 * 4 * 16


@pytest.mark.parametrize("bad", [(0, 10, 16, 128, 100), (1, 0, 16, 128, 100),
                                 (1, 10, -1, 128, 100), (1, 10, 16, 0, 100),
                                 (1, 10, 16, 128, 0),
                                 (1, 10, 16, 128, 2**31)])
def test_plan_refuses_what_the_kernel_does_not_take(bad):
    with pytest.raises(ValueError):
        eb.eb_plan(*bad)


def test_plan_takes_pool_zero():
    p = eb.eb_plan(2, 3, 0, 128, 10)
    assert p.inflight_bytes_per_sm(0) == 0
