"""CUDA kernel K2: quantized EmbeddingBag with the Eq. (5) check fused in.

Replaces ``src/repro/kernels/abft_embeddingbag.py::abft_eb_pallas`` and
the compare its wrapper leaves to XLA.  Source:
``csrc/abft_embeddingbag.cu``; plain versions:
:func:`repro_torch.kernels.ref.abft_eb_ref` (R and rsum; the CPU path),
:func:`repro_torch.kernels.ref.abft_eb_slot_order_ref` (R in the kernel's
summation order) and :func:`repro_torch.core.verify_bags` (the flags).

What bounds it on the H100: bytes, read at random — per slot one d-byte
row and the alpha, beta and C_T of a random row, each of those a 32-byte
sector, against ~5 float operations per row byte.  One DLRM request
(26 tables x 10 bags x <= 16 slots of 128-byte rows, ~0.6 MB) is one
round of dependent loads and a launch; the paper's Table I pooling
(26 x 2048 bags x 100) is ~0.8 GB of useful bytes, where the bytes kept
in flight per SM decide.

Design (the source's note has the detail): a warp per bag at d <= 128,
loading 32 indices at once and gathering each slot's alpha, beta, weight
and C_T lane-parallel; rows as 16-byte words, :data:`INFLIGHT` a lane in
flight, several slots a warp load (4 at d 128) and a register transpose
so that each element of R is one lane's slot-order sum: R is bit-exact
with :func:`~repro_torch.kernels.ref.abft_eb_slot_order_ref`.  The lane
that gathers a slot also makes its two terms of ``verify_bags``; every
lane adds them in slot order, and the bag's leader writes its flag.
Each table's flag count and block ticket share a 64-bit word that every
launch leaves zeroed (:func:`_scratch`), so one protected EmbeddingBag
call on the card is one kernel.  Wider rows take a team of warps, one
slot a load; a ragged d, or a table off 16-byte alignment, byte loads.

K2 is launched as a programmatic dependent (Hopper PDL), as K1 and K3
are: it touches no global memory before ``griddepcontrol.wait``, and it
lets the next kernel launch at once.

:func:`eb_plan` makes the launch plan on the host, so the CPU tests check
it; the C entry checks it again.  A shape the kernel does not take
raises.

:func:`eb_unprotected_cuda` is the kernel's unprotected instance, the
overhead benchmarks' baseline (``repro_torch.benchmarks.eb_overhead``): R
alone, through the same plan and loops, without the C_T gather, rsum,
the compare or the count; R is bit-exact with the protected kernel's.
Its plain version is :func:`repro_torch.core.embedding_bag`.  It is not
a TPU kernel's port and nothing on the serving path calls it.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import EB_REL_BOUND
from repro_torch.kernels import _build

_NAME = "abft_embeddingbag"

#: the H100's streaming multiprocessors
SMS = 132
#: threads a block may have, and blocks of that size an SM holds at least
#: (``__launch_bounds__(256, 3)`` in the source)
MAX_THREADS = 256
MIN_BLOCKS_PER_SM = 3
#: slots whose indices a warp loads at once, and row words (slots) a lane
#: keeps in flight (``kPass`` and ``kInflight`` in the source)
PASS = 32
INFLIGHT = 8
#: the bytes in flight an SM needs to keep HBM busy: its share of 3.35
#: TB/s (25 GB/s) times ~1.2 us of latency under load
INFLIGHT_TARGET = 30 * 1024


class EbPlan(NamedTuple):
    vec: bool               # 16-byte row words (else byte loads)
    lanes: int              # words of a row: d / 16, or d bytes
    groups: int             # slots one warp load brings (1 or 4)
    warps_per_bag: int
    bags_per_block: int
    blocks_per_table: int
    tables: int

    @property
    def word(self) -> int:
        return 16 if self.vec else 1

    @property
    def threads(self) -> int:
        return 32 * self.warps_per_bag * self.bags_per_block

    @property
    def blocks(self) -> int:
        return self.tables * self.blocks_per_table

    def inflight_bytes_per_sm(self, pool: int) -> int:
        """Row bytes an SM has in flight at once: its resident warps
        (bounded by the grid and by the occupancy the launch bounds
        promise) times each warp's loading lanes, words in flight and word
        size."""
        per_lane = min(INFLIGHT,
                       math.ceil(min(pool, PASS) / self.groups))
        lanes = min(32, self.lanes * self.groups)
        warps = min(MIN_BLOCKS_PER_SM * MAX_THREADS // 32,
                    math.ceil(self.blocks / SMS) * self.threads // 32)
        return warps * lanes * per_lane * self.word


def eb_plan(tables: int, bags: int, pool: int, d: int, rows: int, *,
            table_addr: int = 0) -> EbPlan:
    """The launch of K2 over ``tables`` tables of ``rows x d`` int8 at
    device address ``table_addr`` (only its alignment is read), with
    ``bags`` bags of ``pool`` slots each.  Raises ``ValueError`` for a
    shape the kernel does not take."""
    if tables < 1 or bags < 1 or pool < 0 or d < 1 or not 1 <= rows < 2**31:
        raise ValueError(f"unsupported EmbeddingBag shape: {tables} tables "
                         f"of {rows} x {d}, {bags} bags of {pool}")
    vec = d % 16 == 0 and table_addr % 16 == 0
    lanes = d // 16 if vec else d
    if vec and lanes <= 8 and 32 % lanes == 0:
        groups, warps_per_bag = 4, 1
    else:
        groups, warps_per_bag = 1, min(MAX_THREADS // 32,
                                       math.ceil(lanes / 32))
    # the most bags a block (at most 8 warps) whose grid still covers
    # every SM; one bag a block where even that does not
    bags_per_block = next(
        b for b in (8, 4, 2, 1)
        if b * warps_per_bag * 32 <= MAX_THREADS
        and (tables * math.ceil(bags / b) >= SMS or b == 1))
    blocks_per_table = math.ceil(bags / bags_per_block)
    if tables * blocks_per_table >= 2**31:
        raise ValueError(f"{tables} x {bags} bags exceed the grid")
    return EbPlan(vec, lanes, groups, warps_per_bag, bags_per_block,
                  blocks_per_table, tables)


#: per (device, stream): a 64-bit word per table, its flag count (high
#: half) and block tickets (low half), zero at rest (the block that draws
#: a table's last ticket re-zeroes it, and launches on one stream run in
#: order)
_SCRATCH: dict = {}


def _scratch(dev: torch.device, stream: int, tables: int) -> int:
    """Pointer to ``tables`` zeroed words in the stream's persistent buffer
    (grown, zeroed, when too small)."""
    buf = _SCRATCH.get((dev.index, stream))
    if buf is None or buf.numel() < tables:
        n = max(tables, 2 * (0 if buf is None else buf.numel()))
        buf = torch.zeros((n,), dtype=torch.int64, device=dev)
        _SCRATCH[(dev.index, stream)] = buf
    return buf.data_ptr()


#: the C signature of ``abft_eb_launch``
ARGTYPES = ([ctypes.c_void_p] * 11
            + [ctypes.c_int, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
               ctypes.c_int, ctypes.c_float] + [ctypes.c_int] * 6
            + [ctypes.c_void_p])


@functools.cache
def _launch():
    return _build.entry(_NAME, "abft_eb_launch", ARGTYPES)


def _check_inputs(name, table_q, alphas, betas, indices, rowsums, weights):
    """Device, contiguity, type and shape checks of both instances.
    -> (tables, rows, d, bags, pool)."""
    ts = [t for t in (table_q, alphas, betas, indices, rowsums, weights)
          if t is not None]
    dev = table_q.device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError(f"{name} needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError(f"{name} needs contiguous inputs")
    if table_q.dtype != torch.int8 or table_q.dim() != 3:
        raise TypeError(f"table_q must be int8 [tables, rows, d], got "
                        f"{table_q.dtype} {tuple(table_q.shape)}")
    tables, rows, d = table_q.shape
    for what, t, dtype in (("alphas", alphas, torch.float32),
                           ("betas", betas, torch.float32),
                           ("rowsums", rowsums, torch.int32)):
        if t is not None and (t.dtype != dtype or t.shape != (tables, rows)):
            raise TypeError(f"{what} must be {dtype} [tables, rows]")
    if indices.dtype != torch.int32 or indices.dim() != 3 or \
            indices.shape[0] != tables:
        raise TypeError("indices must be int32 [tables, bags, pool]")
    _, bags, pool = indices.shape
    if weights is not None and (weights.dtype != torch.float32
                                or weights.shape != indices.shape):
        raise TypeError("weights must be float32 shaped like indices")
    return tables, rows, d, bags, pool


def abft_eb_cuda(table_q: torch.Tensor, alphas: torch.Tensor,
                 betas: torch.Tensor, indices: torch.Tensor,
                 rowsums: Optional[torch.Tensor] = None,
                 weights: Optional[torch.Tensor] = None, *,
                 rel_bound: float = EB_REL_BOUND):
    """Gather, dequantize and bag-sum with the Eq. (5) check, every table
    in one launch.

    table_q int8 [tables, rows, d]; alphas, betas float32 and rowsums
    (C_T, required) int32 [tables, rows]; indices int32 [tables, bags,
    pool] (−1 padded; an index past the table reads its last row);
    weights float32 [tables, bags, pool] or None.  All contiguous, on one
    CUDA device.  Returns ``(R f32 [tables, bags, d], rsum f32 [tables,
    bags], err_bags bool [tables, bags], err_count int32 [tables])``.
    """
    tables, rows, d, bags, pool = _check_inputs(
        "abft_eb_cuda", table_q, alphas, betas, indices, rowsums, weights)
    if rowsums is None:
        raise ValueError("abft_eb_cuda needs the tables' row sums C_T")
    dev = table_q.device
    r = torch.empty((tables, bags, d), dtype=torch.float32, device=dev)
    rsum = torch.empty((tables, bags), dtype=torch.float32, device=dev)
    err_bags = torch.empty((tables, bags), dtype=torch.bool, device=dev)
    if tables == 0 or bags == 0:
        return r, rsum, err_bags, torch.zeros((tables,), dtype=torch.int32,
                                              device=dev)
    plan = eb_plan(tables, bags, pool, d, rows,
                   table_addr=table_q.data_ptr())
    err_count = torch.empty((tables,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        tally = _scratch(dev, stream, tables)
        rc = _launch()(table_q.data_ptr(), alphas.data_ptr(),
                       betas.data_ptr(), rowsums.data_ptr(),
                       indices.data_ptr(),
                       None if weights is None else weights.data_ptr(),
                       r.data_ptr(), rsum.data_ptr(), err_bags.data_ptr(),
                       err_count.data_ptr(), tally, tables, rows, d,
                       bags, pool, rel_bound, int(plan.vec), plan.lanes,
                       plan.groups, plan.warps_per_bag, plan.bags_per_block,
                       plan.blocks_per_table, stream)
    _build.check(_NAME, rc)
    abft_eb_cuda.launches += 1
    return r, rsum, err_bags, err_count


abft_eb_cuda.launches = 0


@functools.cache
def _launch_unprotected():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(_NAME, "eb_unprotected_launch",
                        [p] * 6 + [i, ctypes.c_longlong] + [i] * 9 + [p])


def eb_unprotected_cuda(table_q: torch.Tensor, alphas: torch.Tensor,
                        betas: torch.Tensor, indices: torch.Tensor,
                        weights: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """K2's unprotected instance on the card: R f32 ``[tables, bags, d]``
    alone, bit-exact with :func:`abft_eb_cuda`'s R (the inputs as there,
    without the row sums)."""
    tables, rows, d, bags, pool = _check_inputs(
        "eb_unprotected_cuda", table_q, alphas, betas, indices, None,
        weights)
    dev = table_q.device
    r = torch.empty((tables, bags, d), dtype=torch.float32, device=dev)
    if tables == 0 or bags == 0:
        return r
    plan = eb_plan(tables, bags, pool, d, rows,
                   table_addr=table_q.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launch_unprotected()(
            table_q.data_ptr(), alphas.data_ptr(), betas.data_ptr(),
            indices.data_ptr(),
            None if weights is None else weights.data_ptr(), r.data_ptr(),
            tables, rows, d, bags, pool, int(plan.vec), plan.lanes,
            plan.groups, plan.warps_per_bag, plan.bags_per_block,
            plan.blocks_per_table, stream)
    _build.check(_NAME, rc)
    eb_unprotected_cuda.launches += 1
    return r


eb_unprotected_cuda.launches = 0
