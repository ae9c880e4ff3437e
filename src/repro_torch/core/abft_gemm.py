"""ABFT for low-precision GEMM — the paper's Algorithm 1, in PyTorch.

Scheme (§IV):
  * encode only B (weights): ``rowSum[i] = (Σ_j B[i,j]) mod 127`` kept in int8,
  * run the one int8 GEMM with the checksum fused in (BLAS-3, §IV-A3),
  * verify per row: ``(Σ_j C[i,j]) mod 127 == (A @ rowSum)[i] mod 127`` — any
    mismatch marks row ``i`` corrupted; ``errCount`` is returned with C.

The packed layout is the JAX package's, unchanged: ``B' = [B | block]``
with a 128-column checksum block whose lane 0 holds the checksum and whose
other lanes are zero, so the same encoded weights move between packages.
Row sums of C reduce ``C mod 127`` element-wise before the row sum, which
keeps the verify exact for any ``n``.

Integer products here are the plain versions: float64 matmuls cast back
(exact while ``|Σ| < 2**53``, i.e. always for int8 operands), because
``torch.mm`` on int8 returns int8 and wraps, and CUDA has no int32 ``mm``.
Where the JAX package accumulates in int32 and may wrap (column sums of
a large batch), :func:`wrap_i32` reproduces the two's-complement wrap.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

#: modulus of the paper (§IV-C): largest odd prime in the int8 value range.
MOD = 127

#: width of the packed checksum block (the TPU lane width of the JAX
#: package, kept so encoded weights are interchangeable).
LANE = 128


class AbftGemmOut(NamedTuple):
    c: torch.Tensor           # int32 [m, n] — C_temp, checksum column excluded
    err_rows: torch.Tensor    # bool  [m]    — per-row violation of Eq. (3b)
    err_count: torch.Tensor   # int32 scalar — number of corrupted rows


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    """int64 -> int32 with two's-complement wraparound (jnp int32 sums)."""
    return ((x.to(torch.int64) + 2**31) % 2**32 - 2**31).to(torch.int32)


def int_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Exact integer product as int32: float64 matmul, cast back.

    Exact for the int8/uint8 operands of this package (each product is at
    most 2**15 and ``k`` is far below 2**38), on the CPU and on the card.
    """
    return (a.to(torch.float64) @ b.to(torch.float64)).to(torch.int32)


def encode_weight_checksum(b_q: torch.Tensor, mod: int = MOD) -> torch.Tensor:
    """Alg. 1 lines 2-5: int8 mod-``mod`` row sums of B
    ([..., k, n] -> [..., k])."""
    rs = torch.sum(b_q.to(torch.int32), dim=-1) % mod
    return rs.to(torch.int8)


def pack_encoded_b(b_q: torch.Tensor, checksum: Optional[torch.Tensor] = None,
                   mod: int = MOD, lanes: int = LANE) -> torch.Tensor:
    """Pack B' = [B | checksum-block] (§IV-A3, the JAX package's layout).

    Returns int8 [..., k, n + lanes]: the final ``lanes`` columns hold the
    checksum in lane 0 and zeros elsewhere.
    """
    if checksum is None:
        checksum = encode_weight_checksum(b_q, mod)
    block = torch.zeros(b_q.shape[:-1] + (lanes,), dtype=torch.int8,
                        device=b_q.device)
    block[..., 0] = checksum
    return torch.cat([b_q.to(torch.int8), block], dim=-1)


def _rowsum_mod(c: torch.Tensor, mod: int) -> torch.Tensor:
    """Exact ``(Σ_j c[..., j]) mod mod`` without overflow for any n."""
    return torch.sum(c % mod, dim=-1) % mod


def verify_rows(c: torch.Tensor, check_col: torch.Tensor,
                mod: int = MOD) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eq. (3b) check: per-row mismatch mask + count.

    ``check_col`` is the int32 checksum product column ``A_I @ rowSum``.
    """
    expected = check_col % mod
    got = _rowsum_mod(c, mod)
    err_rows = got != expected
    return err_rows, torch.sum(err_rows).to(torch.int32)


def abft_qgemm(a_q: torch.Tensor, b_q: torch.Tensor,
               checksum: Optional[torch.Tensor] = None,
               mod: int = MOD) -> AbftGemmOut:
    """Algorithm 1 with the checksum product fused into one GEMM (BLAS-3).

    a_q: uint8/int8 [m, k] activations, b_q: int8 [k, n] weights.
    """
    b_packed = pack_encoded_b(b_q, checksum, mod)
    return abft_qgemm_packed(a_q, b_packed, mod)


def abft_qgemm_packed(a_q: torch.Tensor, b_packed: torch.Tensor,
                      mod: int = MOD, lanes: int = LANE) -> AbftGemmOut:
    """GEMM against a pre-packed B' and fused verification."""
    n = b_packed.shape[1] - lanes
    c_full = int_matmul(a_q, b_packed[:, :n + 1])
    c = c_full[:, :n]
    check_col = c_full[:, n]          # lane 0 of the checksum block
    err_rows, err_count = verify_rows(c, check_col, mod)
    return AbftGemmOut(c, err_rows, err_count)


def abft_qgemm_unfused(a_q: torch.Tensor, b_q: torch.Tensor,
                       mod: int = MOD) -> AbftGemmOut:
    """The BLAS-2 baseline the paper argues *against* (§IV-A3 step ③):
    the checksum product is a separate matrix-vector product."""
    checksum = encode_weight_checksum(b_q, mod)
    c = int_matmul(a_q, b_q)
    check_col = int_matmul(a_q, checksum[:, None])[:, 0]
    err_rows, err_count = verify_rows(c, check_col, mod)
    return AbftGemmOut(c, err_rows, err_count)


def encode_activation_checksum(a_q: torch.Tensor) -> torch.Tensor:
    """Column-side encoding: int32 column sums of A ([m, k] -> [k])."""
    return wrap_i32(torch.sum(a_q.to(torch.int64), dim=0))


def column_check(a_q: torch.Tensor, b_q: torch.Tensor) -> torch.Tensor:
    """``encode_activation_checksum(a) @ b`` in int32 (wrapping like jnp).

    The exact expected column sums of ``C = A @ B`` — the second encoding
    axis the single-error repair needs."""
    col_a = encode_activation_checksum(a_q).to(torch.float64)
    return wrap_i32((col_a @ b_q.to(torch.float64)).to(torch.int64))


def correct_single_error(c: torch.Tensor, err_rows: torch.Tensor,
                         col_check: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-error correction (paper §IV intro): row/column checksum
    repair of one flagged cell.

    The mod-127 row check localizes row i (``err_rows``); ``col_check``
    (the exact expected int32 column sums of C) localizes column j and
    gives the additive error, so ``C[i, j]`` is repaired.  Applies only
    when exactly one row and one column are flagged; anything else is left
    untouched for the recompute path.  Returns ``(corrected_c, applied)``.
    """
    delta = wrap_i32(col_check.to(torch.int64)
                     - torch.sum(c.to(torch.int64), dim=0))
    j = torch.argmax(torch.abs(delta))
    i = torch.argmax(err_rows.to(torch.int32))
    one_row = torch.sum(err_rows.to(torch.int32)) == 1
    one_col = torch.sum((delta != 0).to(torch.int32)) == 1
    applied = one_row & one_col
    fix = torch.where(applied, delta[j], torch.zeros_like(delta[j]))
    fixed = c.clone()
    fixed[i, j] += fix
    return fixed, applied


def encode_weight_colsum(b_q: torch.Tensor) -> torch.Tensor:
    """Weight-side column encoding: exact int32 column sums of B
    ([..., k, n] -> [..., n]), amortized at pack time."""
    return torch.sum(b_q.to(torch.int32), dim=-2, dtype=torch.int32)


def correct_weight_flip(c: torch.Tensor, a_q: torch.Tensor,
                        b_packed: torch.Tensor, colsum_ref: torch.Tensor,
                        mod: int = MOD, lanes: int = LANE
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Repair C after a single corrupted *weight* cell ``B[k0, j0]``.

    The stale packed row checksum flags k0, the stale column sum
    (``colsum_ref``, the exact sums of the clean B) flags j0 and gives the
    delta; then ``C[:, j0] -= A[:, k0] * delta``.  Applies only when
    exactly one row and one column are flagged.  Returns
    ``(corrected_c, applied)``.
    """
    n = b_packed.shape[1] - lanes
    b_q = b_packed[:, :n].to(torch.int32)
    row_ref = b_packed[:, n].to(torch.int32)
    row_bad = (torch.sum(b_q, dim=-1, dtype=torch.int32) - row_ref) \
        % mod != 0
    col_delta = torch.sum(b_q, dim=0, dtype=torch.int32) \
        - colsum_ref.to(torch.int32)
    col_bad = col_delta != 0
    k0 = torch.argmax(row_bad.to(torch.int32))
    j0 = torch.argmax(col_bad.to(torch.int32))
    applied = (torch.sum(row_bad.to(torch.int32)) == 1) & \
        (torch.sum(col_bad.to(torch.int32)) == 1)
    fix = torch.where(applied, col_delta[j0], torch.zeros_like(col_delta[j0]))
    fixed = c.clone()
    fixed[:, j0] -= a_q[:, k0].to(torch.int32) * fix
    return fixed, applied


# ---------------------------------------------------------------------------
# Detection-probability model (§IV-C)
# ---------------------------------------------------------------------------

def detect_prob_b_bitflip(m: int, mod: int = MOD) -> float:
    """§IV-C1 fault model 1: P[detect] = 1 - (3/256)^m."""
    if mod != 127:
        raise ValueError("closed form derived for mod=127")
    return 1.0 - (3.0 / 256.0) ** m


def detect_prob_b_random(m: int, mod: int = MOD) -> float:
    """§IV-C1 fault model 2: P[detect] = 1 - (1018/32640)^m."""
    if mod != 127:
        raise ValueError("closed form derived for mod=127")
    return 1.0 - (1018.0 / 32640.0) ** m


def detect_prob_c_random(mod: int = MOD) -> float:
    """§IV-C2 fault model 2: P[detect] ≥ 1 - 1/mod."""
    return 1.0 - 1.0 / mod
