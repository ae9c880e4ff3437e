"""ABFT for low-precision EmbeddingBag — the paper's Algorithm 2 (§V).

EmbeddingBag gathers rows ``I_b`` from a quantized table and returns
``R_b = Σ_{i∈I_b} w_i (α_i · eb_i + β_i · e_d)`` per bag ``b``.

Detection invariant (Eq. 5, extended with optional per-index weights)::

    Σ_j R_b[j]  ==  Σ_{i∈I_b} w_i (α_i · C_T[i] + d · β_i)

with ``C_T[i] = Σ_j table[i, j]`` precomputed in unscaled int32 (§V-B).
Since the output is floating point, equality holds up to round-off; the
bound scales with Σ|terms| (see :func:`verify_bags`).

Batch layout: fixed-shape ``indices [bags, pool]`` padded with ``-1``, as
in the JAX package; padded slots contribute nothing to either side.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

#: paper §V-D: loose relative bound to trade false positives for low-bit misses.
REL_BOUND = 1e-5

#: package-level alias (the name ``repro_torch.core`` exports).
EB_REL_BOUND = REL_BOUND


class AbftEbOut(NamedTuple):
    r: torch.Tensor           # f32 [bags, d]
    err_bags: torch.Tensor    # bool [bags]
    err_count: torch.Tensor   # int32 scalar


def table_rowsums(table_q: torch.Tensor) -> torch.Tensor:
    """Precompute ``C_T``: exact int32 row sums of the int8 table
    ([..., rows, d] -> [..., rows]).  A stacked ``[tables, rows, d]``
    input is summed one table at a time, so no int32 copy of every table
    exists at once."""
    if table_q.dim() > 2:
        return torch.stack([table_rowsums(t) for t in table_q])
    return torch.sum(table_q, dim=-1, dtype=torch.int32)


def _gather_terms(table_q, alphas, betas, indices, weights):
    """Shared gather of (rows, alpha, beta, weight) with padding masked."""
    valid = indices >= 0
    safe_idx = torch.where(valid, indices, torch.zeros_like(indices)).long()
    rows = table_q[safe_idx].to(torch.float32)           # [bags, pool, d]
    a = alphas[safe_idx]                                 # [bags, pool]
    b = betas[safe_idx]
    w = torch.ones_like(a) if weights is None else weights
    w = torch.where(valid, w, torch.zeros_like(w))
    return rows, a, b, w


def embedding_bag(table_q: torch.Tensor, alphas: torch.Tensor,
                  betas: torch.Tensor, indices: torch.Tensor,
                  weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The unprotected low-precision EB (§III-C): per-row dequant + bag sum.

    Takes one table (``[rows, d]``, ``indices [bags, pool]``) or a stack
    (``[tables, rows, d]``, ``[tables, bags, pool]``), gathered one table
    at a time."""
    if table_q.dim() == 3:
        return torch.stack([
            embedding_bag(table_q[t], alphas[t], betas[t], indices[t],
                          None if weights is None else weights[t])
            for t in range(table_q.shape[0])])
    rows, a, b, w = _gather_terms(table_q, alphas, betas, indices, weights)
    deq = a[..., None] * rows + b[..., None]             # [bags, pool, d]
    return torch.sum(w[..., None] * deq, dim=1)          # [bags, d]


def verify_bags(rsum: torch.Tensor, alphas: torch.Tensor, betas: torch.Tensor,
                indices: torch.Tensor, rowsums: torch.Tensor, d: int,
                weights: Optional[torch.Tensor] = None,
                rel_bound: float = REL_BOUND) -> torch.Tensor:
    """The Eq. (5) compare: per-bag error flags from the output row sums.

    ``rsum`` is ``Σ_j R_b[j]`` ([bags]), however the forward pass produced
    it (a reduction of R or the kernel's fused block sum).  This is the one
    definition of the check, shared by every execution path.

    |RSum - CSum| > bound  =>  soft error (Alg. 2 line 5).  The bound
    scales with Σ|terms| rather than with the result: float round-off
    grows with the accumulated magnitude, so a cancellation-heavy bag
    would otherwise false-positive.
    """
    valid = indices >= 0
    safe_idx = torch.where(valid, indices, torch.zeros_like(indices)).long()
    a = alphas[safe_idx]
    b = betas[safe_idx]
    w = torch.ones_like(a) if weights is None else weights
    w = torch.where(valid, w, torch.zeros_like(w))
    ct = rowsums[safe_idx].to(torch.float32)             # [bags, pool]
    csum = torch.sum(w * (a * ct + d * b), dim=-1)       # [bags]
    mag = torch.sum(torch.abs(w) * (torch.abs(a) * torch.abs(ct)
                                    + d * torch.abs(b)), dim=-1)
    tol = rel_bound * torch.clamp(mag, min=1.0)
    return torch.abs(rsum - csum) > tol


def abft_embedding_bag(table_q: torch.Tensor, alphas: torch.Tensor,
                       betas: torch.Tensor, indices: torch.Tensor,
                       rowsums: torch.Tensor,
                       weights: Optional[torch.Tensor] = None,
                       rel_bound: float = REL_BOUND) -> AbftEbOut:
    """Algorithm 2: EB forward + Eq. (5) check per bag."""
    d = table_q.shape[-1]
    r = embedding_bag(table_q, alphas, betas, indices, weights)
    rsum = torch.sum(r, dim=-1)                          # [bags]
    err_bags = verify_bags(rsum, alphas, betas, indices, rowsums, d,
                           weights, rel_bound)
    return AbftEbOut(r, err_bags, torch.sum(err_bags).to(torch.int32))


def eb_overhead_model(m: int, d: int) -> float:
    """§V-C analytic overhead: (3m + d) extra ops over 3md ≈ 1/d + 1/(3m)."""
    return 1.0 / d + 1.0 / (3.0 * m)
