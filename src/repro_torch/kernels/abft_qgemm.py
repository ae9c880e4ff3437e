"""CUDA kernel K1: int8 ABFT GEMM with the mod-127 row verify fused in.

Replaces ``src/repro/kernels/abft_qgemm.py::abft_qgemm_pallas``.
Source: ``csrc/abft_qgemm.cu``; plain version:
:func:`repro_torch.kernels.ref.abft_qgemm_ref`.

What bounds it on the H100: bytes.  Every serving shape has m <= 64
(RWKV prefill 64, decode 4, the head 1 in a prefill; DLRM 10), so each
weight byte feeds at most 128 int8 operations, far below the ~590 per
byte at which the tensor cores rather than HBM would be the limit.  The
least time is one read of ``B'[:, :n+1]``.

Design: stream B' once, at full width, from enough SMs.  Tensor cores
(``mma.sync`` m16n8k32, u8 x s8 for uint8 A, so no zero-point shift) on
tiles of 128 columns x 128 k rows, which the TMA copies into a 4-stage
ring of shared memory.  B' stays N-major as stored (it is the very memory
a fault campaign corrupts); the kernel transposes 4 x 4 bytes in
registers to the K-major fragments.  At m <= 64 one row tile covers m,
so K is split across a thread-block cluster of up to 8 blocks, reduced
through distributed shared memory, as far as one wave of blocks allows
(one block an SM: an SM streams at about its share of HBM).  The row
verify across N tiles adds per-row ``Σ (C mod 127)`` partials with
atomics, and the last block of a row tile to arrive sets the flags and
leaves the row sums and its ticket zeroed, in a buffer kept per device
and stream: one kernel per call (plus a zeroed column-check buffer under
the ``correct`` policy).  Ragged shapes (k or ldb off a multiple of 16,
an operand off 16-byte alignment, which the TMA cannot map) stage the
same tiles with masked byte loads in the same kernel.

Every launch is a programmatic dependent launch (Hopper PDL): K1 may
start while the kernel before it in the stream still runs, and K3, the
row quantizer that writes A, lets it start at once.  Its launch and its
prologue then overlap K3.  The rule that keeps this safe whatever kernel
comes before: **nothing global before the wait.**  Until
``griddepcontrol.wait`` a block only carves its shared memory, zeroes its
row partials, initialises its mbarriers and prefetches the two tensor
maps; it reads and writes no global memory (not A, which K3 writes; not
B', which a fault injection or a repair may just have changed; not the
row-sum scratch, which the previous K1 leaves zeroed; not C, which the
allocator may have handed over from a kernel still reading it).  The wait
returns once the previous grid has completed and its writes are visible.
A refused launch raises; nothing falls back to a plain launch.

:func:`launch_plan` makes the launch plan (row tile, split count, the
aligned or ragged path) on the host, so the CPU tests check it; the C
entry checks it again.  A shape the kernel does not take raises.

:func:`qgemm_unprotected_cuda` is the kernel's unprotected instance:
``C = A @ B'[:, :n]`` from the same packed operand through the same
mainloop, without the checksum column, the mod-127 epilogue or the
scratch, for int8 A (what a disabled plan rule runs on the serving path:
``QGEMM.unprotected``) and uint8 A (the overhead benchmarks' baseline,
``repro_torch.benchmarks.gemm_overhead``).  Its plain version is
:func:`repro_torch.kernels.ref.qgemm_ref`.  It is not a TPU kernel's
port.

Both wrappers take ``out=``: preallocated contiguous outputs, so that a
stack of MoE experts (``kernels.ops``) writes one launch's C into its
slice of one tensor.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional

import torch

from repro_torch.core import LANE
from repro_torch.kernels import _build

_NAME = "abft_qgemm"

#: the H100's streaming multiprocessors: the split aims at one wave of
#: blocks, at most one on each
SMS = 132
#: the cluster sizes the plan takes, largest first: at most the portable 8,
#: and 5 and 7 measured slower than 6 in chip_smoke.py's split sweep
CLUSTER_SIZES = (8, 6, 4, 3, 2, 1)
BN = 128                # tile columns (one 128-byte line of B' per k row)
BK = 128                # k rows per pipeline stage; a split is whole stages
STAGES = 4
MAX_K = 2**16           # int32 sums of |a| <= 255 times |b| <= 128 stay exact
MAX_ROW_TILES = 65535   # the grid's y dimension


class QgemmPlan(NamedTuple):
    bm: int             # rows per tile: 16, 32 or 64
    tiles_m: int
    tiles_n: int        # over the n + 1 columns C and the checksum need
                        # (n for the unprotected instance)
    splits: int         # K splits = the thread-block cluster size
    k_per_split: int    # a multiple of BK
    aligned: bool       # 16-byte cp.async copies (else masked byte loads)

    @property
    def blocks(self) -> int:
        return self.tiles_m * self.tiles_n * self.splits

    @property
    def smem_bytes(self) -> int:
        # 128-byte rows of A and B' per stage, and the slack that aligns
        # the ring to 1024 bytes
        return STAGES * (self.bm + BK) * BN + 1024

    def k_ranges(self, k: int):
        """The ``[start, end)`` k rows of each split."""
        return [(s * self.k_per_split, min(k, (s + 1) * self.k_per_split))
                for s in range(self.splits)]


def launch_plan(m: int, k: int, n: int, *, a_addr: int = 0,
                b_addr: int = 0, protect: bool = True) -> QgemmPlan:
    """The launch of ``A [m, k] @ B' [k, n + 128]`` with A and B' at
    device addresses ``a_addr`` and ``b_addr`` (only their alignment is
    read).  ``protect=False`` plans the unprotected instance: the same row
    tile and split of K, over the n columns of C alone, so that the two
    programs differ by the check's work only (the checksum column's tile,
    the epilogue, the scratch) and not by a split the rule picks for a
    narrower grid.  Raises ``ValueError`` for a shape the kernel does not
    take."""
    return _plan(m, k, n, a_addr % 16 == 0 and b_addr % 16 == 0, protect)


@functools.lru_cache(maxsize=1024)
def _plan(m: int, k: int, n: int, ptrs_aligned: bool,
          protect: bool = True) -> QgemmPlan:
    if m < 1 or k < 1 or n < 1:
        raise ValueError(f"empty GEMM m={m} k={k} n={n}")
    bm = 16 if m <= 16 else 32 if m <= 32 else 64
    tiles_m = math.ceil(m / bm)
    if k > MAX_K or tiles_m > MAX_ROW_TILES:
        raise ValueError(f"unsupported GEMM shape m={m} k={k} n={n}")
    tiles_n = math.ceil((n + 1) / BN)
    aligned = ptrs_aligned and k % 16 == 0 and (n + LANE) % 16 == 0
    # the largest cluster that keeps the grid to one wave; a whole SM
    # streams B' at about its share of HBM, so a second block on an SM
    # doubles that SM's time (chip_smoke.py's split sweep)
    ksteps = math.ceil(k / BK)
    for splits in CLUSTER_SIZES:
        if splits > ksteps or (splits > 1 and
                               tiles_m * tiles_n * splits > SMS):
            continue
        steps_per = math.ceil(ksteps / splits)
        if math.ceil(ksteps / steps_per) == splits:     # no split empty
            break
    if not protect:
        tiles_n = math.ceil(n / BN)
    return QgemmPlan(bm, tiles_m, tiles_n, splits, steps_per * BK, aligned)


#: per (device, stream): int32 [rows | tickets | check], the row sums and
#: tickets zero at rest (each launch leaves the ones it used zeroed, and
#: launches on one stream run in order)
_SCRATCH: dict = {}


def _scratch(dev: torch.device, stream: int, m: int, tiles_m: int):
    """Pointers to zeroed row sums [m] and tickets [tiles_m] and to the
    check scratch [m], in the stream's persistent buffer (grown, zeroed,
    when too small)."""
    buf, rows, tickets = _SCRATCH.get((dev.index, stream), (None, 0, 0))
    if m > rows or tiles_m > tickets:
        rows, tickets = max(m, 2 * rows), max(tiles_m, 2 * tickets)
        buf = torch.zeros((2 * rows + tickets,), dtype=torch.int32,
                          device=dev)
        _SCRATCH[(dev.index, stream)] = (buf, rows, tickets)
    base = buf.data_ptr()
    return base, base + 4 * rows, base + 4 * (rows + tickets)


@functools.cache
def _launch():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(_NAME, "abft_qgemm_launch",
                        [p, i, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i,
                         i, p])


def _out(t: Optional[torch.Tensor], shape, dev, what: str) -> torch.Tensor:
    """A caller's output tensor, checked, or a new one."""
    if t is None:
        return torch.empty(shape, dtype=torch.int32, device=dev)
    if t.dtype != torch.int32 or tuple(t.shape) != tuple(shape) or \
            t.device != dev or not t.is_contiguous():
        raise ValueError(f"out {what} must be a contiguous int32 tensor "
                         f"{tuple(shape)} on {dev}, got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")
    return t


def abft_qgemm_cuda(a_q: torch.Tensor, b_packed: torch.Tensor, *,
                    with_colcheck: bool = False,
                    plan: Optional[QgemmPlan] = None, pdl: bool = True,
                    out: Optional[tuple] = None):
    """Run the fused ABFT GEMM on the card.

    ``a_q``: int8 or uint8 [m, k]; ``b_packed``: int8 [k, n + 128] from
    :func:`repro_torch.core.pack_encoded_b`; both contiguous CUDA tensors
    on one device.  Returns ``(C int32 [m, n], err_rows int32 [m])``, plus
    the Eq.-1 column check ``colsum(A) @ B`` (int32 [n]) when
    ``with_colcheck``.  ``plan`` replaces :func:`launch_plan`'s choice
    (to measure the rule); the C entry refuses one that does not fit.
    ``pdl=False`` launches K1 as a plain successor of the kernel before it,
    only to measure what programmatic dependent launch buys.  ``out``
    ``(c, err_rows)`` are written instead of new tensors.
    """
    if not (a_q.is_cuda and b_packed.is_cuda) or a_q.device != b_packed.device:
        raise ValueError("abft_qgemm_cuda needs both operands on one CUDA "
                         "device")
    if a_q.dtype not in (torch.int8, torch.uint8):
        raise TypeError(f"a_q must be int8 or uint8, got {a_q.dtype}")
    if b_packed.dtype != torch.int8:
        raise TypeError(f"b_packed must be int8 (pack_encoded_b output), "
                        f"got {b_packed.dtype}")
    if a_q.dim() != 2 or b_packed.dim() != 2 or \
            not (a_q.is_contiguous() and b_packed.is_contiguous()):
        raise ValueError("operands must be contiguous 2-D tensors")
    m, k = a_q.shape
    k2, ldb = b_packed.shape
    n = ldb - LANE
    if k != k2 or n < 1 or k < 1:
        raise ValueError(f"shape mismatch: A {tuple(a_q.shape)}, "
                         f"B' {tuple(b_packed.shape)}")
    dev = a_q.device
    c_out, err_out = (None, None) if out is None else out
    c = _out(c_out, (m, n), dev, "C")
    err = _out(err_out, (m,), dev, "err_rows")
    if m == 0:
        if with_colcheck:
            return c, err, torch.zeros((n,), dtype=torch.int32, device=dev)
        return c, err
    if plan is None:
        plan = launch_plan(m, k, n, a_addr=a_q.data_ptr(),
                           b_addr=b_packed.data_ptr())
    col = (torch.zeros((n,), dtype=torch.int32, device=dev)
           if with_colcheck else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rowsum, ticket, check = _scratch(dev, stream, m, plan.tiles_m)
        rc = _launch()(a_q.data_ptr(), int(a_q.dtype == torch.uint8),
                       b_packed.data_ptr(), c.data_ptr(), err.data_ptr(),
                       rowsum, check, ticket,
                       None if col is None else col.data_ptr(), m, n, k, ldb,
                       plan.bm, plan.splits, plan.k_per_split,
                       int(plan.aligned), int(pdl), stream)
    _build.check(_NAME, rc)
    abft_qgemm_cuda.launches += 1
    if with_colcheck:
        return c, err, col
    return c, err


abft_qgemm_cuda.launches = 0


@functools.cache
def _launch_unprotected():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(_NAME, "qgemm_unprotected_launch",
                        [p, i, p, p, i, i, i, i, i, i, i, i, p])


def qgemm_unprotected_cuda(a_q: torch.Tensor, b_packed: torch.Tensor, *,
                           out: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """K1's unprotected instance on the card: ``C = A @ B'[:, :n]``, int32
    ``[m, n]``, bit-exact with the protected kernel's C.

    ``a_q``: int8 (the serving path's signed codes) or uint8 (the
    overhead benchmark's A) [m, k]; ``b_packed``: int8 [k, n + 128]; both
    contiguous CUDA tensors on one device.  The plan is
    :func:`launch_plan`'s (``protect=False``).  ``out`` is written
    instead of a new C."""
    if not (a_q.is_cuda and b_packed.is_cuda) or a_q.device != b_packed.device:
        raise ValueError("qgemm_unprotected_cuda needs both operands on one "
                         "CUDA device")
    if a_q.dtype not in (torch.int8, torch.uint8) or \
            b_packed.dtype != torch.int8:
        raise TypeError(f"qgemm_unprotected_cuda takes int8 or uint8 A and "
                        f"int8 B', got {a_q.dtype} and {b_packed.dtype}")
    if a_q.dim() != 2 or b_packed.dim() != 2 or \
            not (a_q.is_contiguous() and b_packed.is_contiguous()):
        raise ValueError("operands must be contiguous 2-D tensors")
    m, k = a_q.shape
    k2, ldb = b_packed.shape
    n = ldb - LANE
    if k != k2 or n < 1 or k < 1:
        raise ValueError(f"shape mismatch: A {tuple(a_q.shape)}, "
                         f"B' {tuple(b_packed.shape)}")
    dev = a_q.device
    c = _out(out, (m, n), dev, "C")
    if m == 0:
        return c
    plan = launch_plan(m, k, n, a_addr=a_q.data_ptr(),
                       b_addr=b_packed.data_ptr(), protect=False)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        rc = _launch_unprotected()(a_q.data_ptr(),
                                   int(a_q.dtype == torch.uint8),
                                   b_packed.data_ptr(),
                                   c.data_ptr(), m, n, k, ldb, plan.bm,
                                   plan.splits, plan.k_per_split,
                                   int(plan.aligned), stream)
    _build.check(_NAME, rc)
    qgemm_unprotected_cuda.launches += 1
    return c


qgemm_unprotected_cuda.launches = 0
