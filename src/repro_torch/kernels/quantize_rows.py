"""CUDA kernel K3: per-row dynamic activation quantization (signed int8).

Replaces ``src/repro/kernels/quantize_rows.py::quantize_rows_pallas``.
Source: ``csrc/quantize_rows.cu``; plain version:
:func:`repro_torch.kernels.ref.quantize_rows_ref`.

What bounds it on the H100: bytes.  It reads 4 bytes and writes 1 per
element (plus 8 per row) and does a handful of float operations per
element, far below the card's ratio of operations to bytes.  On the DLRM
path rows are at most 1024 wide and m is the lookup batch (10), so one
call moves at most ~50 KB and its time is the launch itself.

Design: one block of 256 threads per row — a min/max reduction, then a
second pass over the row (now in L1/L2) that writes q.  The arithmetic is
written with round-to-nearest intrinsics, IEEE division and ``rintf``, so
q, alpha and beta are bit-exact with the plain version; that is what
makes the GEMM's int32 output, and hence its checks, equal on both paths.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "quantize_rows"


@functools.cache
def _launch():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(_NAME, "quantize_rows_launch", [p, p, p, p, i, i, p])


def quantize_rows_cuda(x: torch.Tensor):
    """f32 [m, n] on the card -> (q int8 [m, n], alpha f32 [m], beta f32 [m]).

    ``x`` must be a contiguous float32 CUDA tensor with ``n >= 1``; the
    caller casts (``kernels.ops.quantize_rows`` does)."""
    if not x.is_cuda:
        raise ValueError("quantize_rows_cuda needs a CUDA tensor")
    if x.dtype != torch.float32 or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 [m, n], got "
                         f"{x.dtype} {tuple(x.shape)}")
    m, n = x.shape
    if n < 1 or m >= 2**31 or m * n >= 2**62:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    alpha = torch.empty((m,), dtype=torch.float32, device=x.device)
    beta = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, alpha, beta
    with torch.cuda.device(x.device):
        err = _launch()(x.data_ptr(), q.data_ptr(), alpha.data_ptr(),
                        beta.data_ptr(), m, n,
                        torch.cuda.current_stream().cuda_stream)
    _build.check(_NAME, err)
    quantize_rows_cuda.launches += 1
    return q, alpha, beta


quantize_rows_cuda.launches = 0
