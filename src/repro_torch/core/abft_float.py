"""Beyond-paper: float ABFT for training-time (bf16/f32) GEMMs (the JAX
package's ``core/abft_float.py``).

The paper scopes ABFT to int8 inference (§III); training matmuls are bf16.
Classic HPC float ABFT (Huang & Abraham '84 with a round-off bound) applies:
encode B with exact f32 row sums, verify row sums of C against ``A @ s_B``
within a norm-scaled tolerance.

The bound follows the standard forward-error model for inner products:
|fp(sum) - sum| ≤ k·eps·Σ|terms|, so the tolerance scales with the
accumulated magnitude row-wise rather than a single global epsilon.  The
products are plain ``torch.matmul`` calls in float32 (the JAX package
leaves them to XLA, outside any kernel); on the card they match the
float32 reference only with TF32 off, which is PyTorch's default.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class FloatAbftOut(NamedTuple):
    c: torch.Tensor
    err_rows: torch.Tensor
    err_count: torch.Tensor


def encode_weight_f32(b: torch.Tensor) -> torch.Tensor:
    """f32 row sums of B ([k, n] -> [k]); computed once per weight
    version."""
    return torch.sum(b.to(torch.float32), dim=-1)


def abft_gemm_f32(a: torch.Tensor, b: torch.Tensor,
                  checksum: Optional[torch.Tensor] = None,
                  rel_bound: float = 1e-3) -> FloatAbftOut:
    """C = A @ B with row-sum verification under a round-off-aware bound.

    ``rel_bound`` is deliberately loose for bf16 inputs (the paper's EB
    reasoning §V-D: small float fluctuations rarely change inference
    outcomes; only large corruptions matter).
    """
    if checksum is None:
        checksum = encode_weight_f32(b)
    c = a.to(torch.float32) @ b.to(torch.float32)
    got = torch.sum(c, dim=-1)
    expected = a.to(torch.float32) @ checksum
    # round-off scale: the cheap surrogate Σ|C_row| bounds the accumulated
    # magnitude
    scale = torch.sum(torch.abs(c), dim=-1) + 1.0
    err_rows = torch.abs(got - expected) > rel_bound * scale
    return FloatAbftOut(c, err_rows, torch.sum(err_rows, dtype=torch.int32))
