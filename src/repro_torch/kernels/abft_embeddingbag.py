"""CUDA kernel K2: quantized EmbeddingBag with the Eq. (5) row sum fused in.

Replaces ``src/repro/kernels/abft_embeddingbag.py::abft_eb_pallas``.
Source: ``csrc/abft_embeddingbag.cu``; plain version:
:func:`repro_torch.kernels.ref.abft_eb_ref`.  The Eq. (5) compare stays
in the one shared :func:`repro_torch.core.verify_bags`.

What bounds it on the H100: bytes — the rows it gathers (d bytes each)
plus their alpha and beta, against ~3 float operations per gathered
byte.  On the DLRM path that is at most 26 tables x 10 bags x 16 slots
of 128-byte rows per request (~0.6 MB), scattered over 13.3 GB of
tables, so each row is a cold random read and latency, not bandwidth,
sets the time.

Design: one launch for all tables, grid (bags, tables), threads across
d.  A block walks its bag's pool in slot order — no atomics, and the
TPU's scalar-prefetched index stream becomes the block loading its own
indices.  Row offsets are 64-bit.  Each term keeps the plain version's
rounding (``w * (alpha * row + beta)``, no FMA); the sums run in another
order, which the float tolerance of the tests states.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from repro_torch.kernels import _build

_NAME = "abft_embeddingbag"


@functools.cache
def _launch():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(_NAME, "abft_eb_launch",
                        [p, p, p, p, p, p, p, i, ctypes.c_longlong, i, i, i,
                         p])


def abft_eb_cuda(table_q: torch.Tensor, alphas: torch.Tensor,
                 betas: torch.Tensor, indices: torch.Tensor,
                 weights: Optional[torch.Tensor] = None):
    """Gather-and-sum with the fused row sum, every table in one launch.

    table_q int8 [tables, rows, d]; alphas, betas f32 [tables, rows];
    indices int32 [tables, bags, pool] (−1 padded, each below ``rows``);
    weights f32 [tables, bags, pool] or None.  All contiguous, on one CUDA
    device.  Returns ``(R f32 [tables, bags, d], rsum f32 [tables, bags])``.
    """
    ts = [table_q, alphas, betas, indices] + \
        ([] if weights is None else [weights])
    dev = table_q.device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError("abft_eb_cuda needs every input on one CUDA device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("abft_eb_cuda needs contiguous inputs")
    if table_q.dtype != torch.int8 or table_q.dim() != 3:
        raise TypeError(f"table_q must be int8 [tables, rows, d], got "
                        f"{table_q.dtype} {tuple(table_q.shape)}")
    tables, rows, d = table_q.shape
    if alphas.dtype != torch.float32 or betas.dtype != torch.float32 or \
            alphas.shape != (tables, rows) or betas.shape != (tables, rows):
        raise TypeError("alphas and betas must be float32 [tables, rows]")
    if indices.dtype != torch.int32 or indices.dim() != 3 or \
            indices.shape[0] != tables:
        raise TypeError("indices must be int32 [tables, bags, pool]")
    _, bags, pool = indices.shape
    if weights is not None and (weights.dtype != torch.float32
                                or weights.shape != indices.shape):
        raise TypeError("weights must be float32 shaped like indices")
    if rows < 1 or d < 1 or rows >= 2**31 or tables > 65535:
        raise ValueError(f"unsupported table shape {tuple(table_q.shape)}")
    r = torch.empty((tables, bags, d), dtype=torch.float32, device=dev)
    rsum = torch.empty((tables, bags), dtype=torch.float32, device=dev)
    if tables == 0 or bags == 0:
        return r, rsum
    with torch.cuda.device(dev):
        rc = _launch()(table_q.data_ptr(), alphas.data_ptr(),
                       betas.data_ptr(), indices.data_ptr(),
                       None if weights is None else weights.data_ptr(),
                       r.data_ptr(), rsum.data_ptr(), tables, rows, d, bags,
                       pool, torch.cuda.current_stream().cuda_stream)
    _build.check(_NAME, rc)
    abft_eb_cuda.launches += 1
    return r, rsum


abft_eb_cuda.launches = 0
