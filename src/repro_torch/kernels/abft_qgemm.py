"""CUDA kernel K1: int8 ABFT GEMM with the mod-127 row verify fused in.

Replaces ``src/repro/kernels/abft_qgemm.py::abft_qgemm_pallas``.
Source: ``csrc/abft_qgemm.cu``; plain version:
:func:`repro_torch.kernels.ref.abft_qgemm_ref`.

What bounds it on the H100: bytes, on the DLRM path.  At m = 10 each
weight byte is used in 10 multiply-adds, far below the card's ~590
int8 operations per byte of HBM traffic, so the least time is reading
B'[:, :n+1] once.  At large m (the paper's Fig. 5 GEMMs) it turns to
operations, where this first version — integer multiply-adds on the CUDA
cores, not the tensor cores — sits far from the int8 peak; ``wgmma`` and
TMA are the later work.

Design: 64 x 64 output tiles over (m, n+1) — only column n of the
128-lane checksum block is computed, the other 127 lanes are TPU padding.
The Pallas kernel carries the row sum across N tiles in grid order; here
blocks run in any order, so each adds its tile's ``Σ (C mod 127)``
(already reduced below 127) into an int32 row buffer with ``atomicAdd``
and a finisher compares it with ``C[:, n] mod 127``.  The optional column
check is a matvec over the operand tiles accumulated with unsigned
atomics, exact in any order.  uint8 A is multiplied as unsigned values,
so no zero-point correction is needed.  Ragged edges are masked in the
kernel; nothing is padded or copied.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.core import LANE
from repro_torch.kernels import _build

_NAME = "abft_qgemm"


@functools.cache
def _launch():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(_NAME, "abft_qgemm_launch",
                        [p, i, p, p, p, p, p, i, i, i, i, p])


def abft_qgemm_cuda(a_q: torch.Tensor, b_packed: torch.Tensor, *,
                    with_colcheck: bool = False):
    """Run the fused ABFT GEMM on the card.

    ``a_q``: int8 or uint8 [m, k]; ``b_packed``: int8 [k, n + 128] from
    :func:`repro_torch.core.pack_encoded_b`; both contiguous CUDA tensors
    on one device.  Returns ``(C int32 [m, n], err_rows int32 [m])``, plus
    the Eq.-1 column check ``colsum(A) @ B`` (int32 [n]) when
    ``with_colcheck``.
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
    # int32 accumulation of |a| <= 255 times |b| <= 128 stays exact below
    # k = 2**16; the grid's y dimension holds at most 65535 row tiles
    if k > 2**16 or m > 65535 * 64:
        raise ValueError(f"unsupported GEMM shape m={m} k={k} n={n}")
    dev = a_q.device
    c = torch.empty((m, n), dtype=torch.int32, device=dev)
    err = torch.empty((m,), dtype=torch.int32, device=dev)
    col = (torch.empty((n,), dtype=torch.int32, device=dev)
           if with_colcheck else None)
    if m == 0:
        if col is not None:
            col.zero_()
            return c, err, col
        return c, err
    scratch = torch.empty((2 * m,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _launch()(a_q.data_ptr(), int(a_q.dtype == torch.uint8),
                       b_packed.data_ptr(), c.data_ptr(), err.data_ptr(),
                       None if col is None else col.data_ptr(),
                       scratch.data_ptr(), m, n, k, ldb,
                       torch.cuda.current_stream().cuda_stream)
    _build.check(_NAME, rc)
    abft_qgemm_cuda.launches += 1
    if with_colcheck:
        return c, err, col
    return c, err


abft_qgemm_cuda.launches = 0
