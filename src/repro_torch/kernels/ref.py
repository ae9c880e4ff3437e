"""Plain PyTorch versions of the three CUDA kernels.

Each takes the same inputs as its kernel and returns the same outputs.
The CPU path runs them; on the card they are the reference the kernels
are held against, and nothing on the main path calls them there.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import LANE, MOD, column_check, embedding_bag, \
    int_matmul


def abft_qgemm_ref(a_q: torch.Tensor, b_packed: torch.Tensor,
                   with_colcheck: bool = False, mod: int = MOD):
    """Plain K1: ``(C int32 [m,n], err_rows int32 [m])``, plus the Eq.-1
    column check ``colsum(A) @ B`` (int32 [n]) when ``with_colcheck``."""
    n = b_packed.shape[1] - LANE
    c_full = int_matmul(a_q, b_packed[:, :n + 1])
    c = c_full[:, :n]
    check = c_full[:, n] % mod
    rowsum = torch.sum(c % mod, dim=1) % mod
    err = (rowsum != check).to(torch.int32)
    if not with_colcheck:
        return c, err
    return c, err, column_check(a_q, b_packed[:, :n])


def abft_eb_ref(table_q: torch.Tensor, alphas: torch.Tensor,
                betas: torch.Tensor, indices: torch.Tensor,
                weights: Optional[torch.Tensor] = None):
    """Plain K2: ``(R f32 [..., bags, d], rsum f32 [..., bags])`` for one
    table or a stack of them (see :func:`repro_torch.core.embedding_bag`)."""
    r = embedding_bag(table_q, alphas, betas, indices, weights)
    return r, torch.sum(r, dim=-1)


def quantize_rows_ref(x: torch.Tensor):
    """Plain K3: per-row signed-int8 affine quantization.
    f32 [m, n] -> (q int8 [m, n], alpha f32 [m], beta f32 [m])."""
    x = x.to(torch.float32)
    xmin = torch.amin(x, dim=1)
    xmax = torch.amax(x, dim=1)
    span = torch.clamp(xmax - xmin, min=1e-12)
    # a tensor divisor: on CUDA, PyTorch divides by a Python scalar as a
    # multiply by its reciprocal, which is not the IEEE quotient the JAX
    # oracle (and the kernel) computes
    alpha = span / torch.full_like(span, 255.0)
    beta = xmin + 128.0 * alpha
    q = torch.clamp(torch.round((x - beta[:, None]) / alpha[:, None]),
                    -128, 127)
    return q.to(torch.int8), alpha, beta
