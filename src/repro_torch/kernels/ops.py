"""The operator surface over the three kernels, with one dispatch rule.

A CUDA tensor takes the hand-written kernel; a CPU tensor takes the plain
PyTorch version.  An explicit ``use_kernel`` always wins: ``False`` takes
the plain version on any device (the JAX package's precedence rule for
``use_pallas=False``), and ``True`` on a CPU tensor raises — a CUDA kernel
has no interpret mode, and nothing falls back silently.

The :mod:`repro_torch.protect` adapters dispatch here; layer code should
not call these directly.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import AbftEbOut, EB_REL_BOUND, verify_bags
from repro_torch.kernels import ref as _ref


def _use_kernel(use_kernel: Optional[bool], x: torch.Tensor) -> bool:
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors; pass "
                         "use_kernel=False (or leave it unset) on the CPU")
    return bool(use_kernel)


def abft_qgemm(a_q: torch.Tensor, b_packed: torch.Tensor, *,
               use_kernel: Optional[bool] = None,
               with_colcheck: bool = False):
    """ABFT int8 GEMM against a packed B'. -> (C int32, err_rows int32 [m]),
    plus the exact int32 column check ``colsum(A) @ B`` with
    ``with_colcheck`` (what the ``correct`` policy consumes)."""
    if _use_kernel(use_kernel, a_q):
        from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
        return abft_qgemm_cuda(a_q.contiguous(), b_packed.contiguous(),
                               with_colcheck=with_colcheck)
    return _ref.abft_qgemm_ref(a_q, b_packed, with_colcheck=with_colcheck)


def abft_embedding_bag(table_q, alphas, betas, indices, rowsums,
                       weights=None, *, rel_bound: float = EB_REL_BOUND,
                       use_kernel: Optional[bool] = None) -> AbftEbOut:
    """EB forward + Eq. (5) check. -> AbftEbOut(r, err_bags, err_count).

    Takes one table (``[rows, d]``, ``indices [bags, pool]``; err_count
    is a scalar) or a stack (``[tables, rows, d]``, ``[tables, bags,
    pool]``; err_count is a ``[tables]`` vector, one check per table)."""
    stacked = table_q.dim() == 3
    if not stacked:
        out = abft_embedding_bag(table_q[None], alphas[None], betas[None],
                                 indices[None], rowsums[None],
                                 None if weights is None else weights[None],
                                 rel_bound=rel_bound, use_kernel=use_kernel)
        return AbftEbOut(out.r[0], out.err_bags[0], out.err_count[0])
    if _use_kernel(use_kernel, table_q):
        from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
        r, rsum = abft_eb_cuda(
            table_q, alphas, betas, indices.to(torch.int32).contiguous(),
            None if weights is None else weights.contiguous())
    else:
        r, rsum = _ref.abft_eb_ref(table_q, alphas, betas, indices, weights)
    # ONE Eq. (5) definition for every path: the tables are flattened into
    # one row space so a single verify_bags call checks every bag
    tables, rows, d = table_q.shape
    offs = (torch.arange(tables, device=indices.device)
            * rows).reshape(-1, 1, 1)
    flat_idx = torch.where(indices >= 0, indices.long() + offs,
                           torch.full_like(indices, -1, dtype=torch.long))
    pool = indices.shape[-1]
    err_bags = verify_bags(
        rsum.reshape(-1), alphas.reshape(-1), betas.reshape(-1),
        flat_idx.reshape(-1, pool), rowsums.reshape(-1), d,
        None if weights is None else weights.reshape(-1, pool),
        rel_bound).reshape(tables, -1)
    return AbftEbOut(r, err_bags, torch.sum(err_bags, dim=-1,
                                            dtype=torch.int32))


def quantize_rows(x: torch.Tensor, *, use_kernel: Optional[bool] = None):
    """Per-row signed-int8 dynamic quantization. -> (q, alpha, beta).
    The input is cast to float32 here, as the JAX wrapper casts it."""
    x = x.to(torch.float32).contiguous()
    if _use_kernel(use_kernel, x):
        from repro_torch.kernels.quantize_rows import quantize_rows_cuda
        return quantize_rows_cuda(x)
    return _ref.quantize_rows_ref(x)
