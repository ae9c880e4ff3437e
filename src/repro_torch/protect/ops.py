"""The :class:`ProtectedOp` protocol and the registered adapters.

Every ABFT-protected operator family exposes one uniform surface:

* ``encode(params) -> encoded`` — the amortized, load-time encoding step
  (pack the weight checksum, precompute table row sums);
* ``__call__(encoded, *inputs, rule=...) -> (out, Check)`` — the protected
  hot-path call: run the op, verify, return the result plus a
  :class:`Check`;
* ``unprotected(encoded, *inputs) -> out`` — the baseline a disabled plan
  rule runs.

Adapters registered here: ``qgemm`` and ``embedding_bag``, dispatching
through :mod:`repro_torch.kernels.ops`, and ``float_gemm`` (a plain
float32 product, as the JAX package leaves it to XLA).  The KV-cache
adapters of the JAX package wait for a later slice (ROADMAP A4); their
op kinds are already report keys (:mod:`repro_torch.core.policy`).

Scheme names carry over from JAX plans: ``pallas`` ("force the kernel")
is a synonym of the port's ``cuda`` scheme, and the EmbeddingBag's
``xla`` of its ``plain`` scheme.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Protocol, Tuple, \
    runtime_checkable

import torch

from repro_torch.core import (EB_REL_BOUND, LANE, abft_gemm_f32,
                              column_check, correct_single_error,
                              correct_weight_flip, embedding_bag,
                              encode_weight_f32, int_matmul, pack_encoded_b,
                              table_rowsums, verify_rows)
from repro_torch.core.policy import register_op_kind
from repro_torch.kernels import ops as kops
from repro_torch.protect.plan import ResolvedRule

_DEFAULT_RULE = ResolvedRule()


class Check(NamedTuple):
    """What a protected call learned: residual error count (a scalar, or
    one count per independent check, e.g. per table), an optional
    per-row/bag error mask, and adapter-specific correction aux."""
    err_count: torch.Tensor
    err_mask: Optional[torch.Tensor] = None
    aux: Any = None


@runtime_checkable
class ProtectedOp(Protocol):
    """Structural protocol every adapter satisfies."""
    name: str
    schemes: Tuple[str, ...]
    supports_correct: bool

    def encode(self, params): ...                        # noqa: E704

    def __call__(self, encoded, *inputs, rule=None): ...  # noqa: E704

    def unprotected(self, encoded, *inputs): ...         # noqa: E704


# ---------------------------------------------------------------------------
# int8 GEMM (paper Algorithm 1)
# ---------------------------------------------------------------------------

class QGemmOp:
    """Quantized GEMM: encoded = packed B' (int8 [k, n+LANE]), input = A_q.

    Schemes: ``packed`` (fused checksum column: the CUDA kernel on the
    card, the plain version on the CPU), ``cuda`` (force the kernel; its
    synonym ``pallas`` keeps JAX plan strings valid), ``plain`` (the plain
    PyTorch version on any device), ``unfused`` (the BLAS-2 baseline the
    paper argues against, §IV-A3).

    ``encoded`` may also be ``(packed, colsum_ref)`` where ``colsum_ref``
    is the exact int32 column sums of the clean B block; with it the
    ``correct`` policy also repairs single *weight* flips.
    """
    name = "qgemm"
    schemes = ("packed", "plain", "cuda", "pallas", "unfused")
    supports_correct = True
    lane = LANE

    def encode(self, w_q: torch.Tensor) -> torch.Tensor:
        return pack_encoded_b(w_q)

    @staticmethod
    def _unpack(encoded):
        if isinstance(encoded, tuple):
            return encoded
        return encoded, None

    def out_dim(self, encoded) -> int:
        packed, _ = self._unpack(encoded)
        return packed.shape[-1] - LANE

    def dequant_colsum(self, w_q: torch.Tensor) -> torch.Tensor:
        """The Eq. 1 rank-1 requantization constant: f32 column sums of
        the int8 weight block ([..., k, n] -> [..., n])."""
        return torch.sum(w_q.to(torch.int32), dim=-2,
                         dtype=torch.int32).to(torch.float32)

    def _aux(self, col_check, a_q, packed, colsum_ref):
        if col_check is not None and colsum_ref is not None:
            return {"col_check": col_check, "a_q": a_q, "packed": packed,
                    "colsum_ref": colsum_ref}
        return col_check

    def __call__(self, encoded, a_q, *, rule: ResolvedRule = _DEFAULT_RULE):
        packed, colsum_ref = self._unpack(encoded)
        scheme = rule.scheme or "packed"
        want_col = rule.policy == "correct"
        n = self.out_dim(packed)
        if scheme == "unfused":
            b_q = packed[:, :n]
            checksum = packed[:, n:n + 1]                  # lane 0 of block
            c = int_matmul(a_q, b_q)
            check_col = int_matmul(a_q, checksum)[:, 0]
            err_rows, err = verify_rows(c, check_col)
            col = column_check(a_q, b_q) if want_col else None
            return c, Check(err, err_rows,
                            self._aux(col, a_q, packed, colsum_ref))
        if scheme not in ("packed", "plain", "cuda", "pallas"):
            raise ValueError(f"unknown qgemm scheme {scheme!r}; "
                             f"have {self.schemes}")
        use_kernel = {"packed": None, "plain": False}.get(scheme, True)
        out = kops.abft_qgemm(a_q, packed, use_kernel=use_kernel,
                              with_colcheck=want_col)
        if want_col:
            c, err_rows, col = out
        else:
            (c, err_rows), col = out, None
        return c, Check(torch.sum(err_rows, dtype=torch.int32),
                        err_rows.to(torch.bool),
                        self._aux(col, a_q, packed, colsum_ref))

    def unprotected(self, encoded, a_q):
        packed, _ = self._unpack(encoded)
        return int_matmul(a_q, packed[:, :self.out_dim(packed)])

    def correct(self, out, check: Check):
        """Single-error repair; returns (fixed, residual_err, applied).

        Tries the single-cell accumulator repair first, then (when the
        encoded side carried a column-sum reference) the weight-flip
        repair.  The two cannot mis-fire together: a weight flip leaves
        the accumulator column deltas self-consistent (zero), and a clean
        B leaves the weight encodings self-consistent.
        """
        aux = check.aux
        if isinstance(aux, dict):
            fixed, cell = correct_single_error(out, check.err_mask,
                                               aux["col_check"])
            fixed, wflip = correct_weight_flip(fixed, aux["a_q"],
                                               aux["packed"],
                                               aux["colsum_ref"])
            applied = cell | wflip
        else:
            fixed, applied = correct_single_error(out, check.err_mask, aux)
        residual = torch.where(applied, torch.zeros_like(check.err_count),
                               check.err_count).to(torch.int32)
        return fixed, residual, applied.to(torch.int32)


# ---------------------------------------------------------------------------
# float GEMM (beyond-paper: training-time bf16/f32 matmuls)
# ---------------------------------------------------------------------------

class FloatGemmOp:
    """Float ABFT GEMM: encoded = (W, f32 row sums | None), input = A.
    With no row sums they are taken from W at the call (the JAX
    ``linear``'s way), so only a fault in the product shows; row sums
    encoded ahead also show a fault in W itself."""
    name = "float_gemm"
    schemes = ("default",)
    supports_correct = False

    def encode(self, w: torch.Tensor):
        return (w, encode_weight_f32(w))

    def __call__(self, encoded, a, *, rule: ResolvedRule = _DEFAULT_RULE):
        w, checksum = encoded if isinstance(encoded, tuple) else (encoded,
                                                                  None)
        rel = 1e-3 if rule.rel_bound is None else rule.rel_bound
        out = abft_gemm_f32(a, w, checksum=checksum, rel_bound=rel)
        return out.c, Check(out.err_count, out.err_rows)

    def unprotected(self, encoded, a):
        w = encoded[0] if isinstance(encoded, tuple) else encoded
        return a.to(torch.float32) @ w.to(torch.float32)


# ---------------------------------------------------------------------------
# EmbeddingBag (paper Algorithm 2)
# ---------------------------------------------------------------------------

class EmbeddingBagOp:
    """Quantized EB: encoded = (table_q, alphas, betas, rowsums);
    inputs = (indices [bags, pool] (−1 padded), optional weights).

    The table may be a stack ``[tables, rows, d]`` with indices
    ``[tables, bags, pool]``: one kernel launch, and one check per table
    (the err count is then a ``[tables]`` vector)."""
    name = "embedding_bag"
    schemes = ("plain", "xla", "cuda", "pallas")
    supports_correct = False
    default_rel_bound = EB_REL_BOUND

    def encode(self, params):
        """(table, alphas, betas) -> the 4-tuple with fresh row sums."""
        table_q, alphas, betas = params
        return (table_q, alphas, betas, table_rowsums(table_q))

    def __call__(self, encoded, indices, weights=None, *,
                 rule: ResolvedRule = _DEFAULT_RULE):
        table_q, alphas, betas, rowsums = encoded
        rel = self.default_rel_bound if rule.rel_bound is None \
            else rule.rel_bound
        if rule.scheme is None:
            use_kernel = None                      # auto: kernel on CUDA
        elif rule.scheme in ("cuda", "pallas"):
            use_kernel = True
        elif rule.scheme in ("plain", "xla"):
            use_kernel = False
        else:
            raise ValueError(f"unknown embedding_bag scheme "
                             f"{rule.scheme!r}; have {self.schemes}")
        out = kops.abft_embedding_bag(table_q, alphas, betas, indices,
                                      rowsums, weights, rel_bound=rel,
                                      use_kernel=use_kernel)
        return out.r, Check(out.err_count, out.err_bags)

    def unprotected(self, encoded, indices, weights=None):
        table_q, alphas, betas, _ = encoded
        return embedding_bag(table_q, alphas, betas, indices, weights)


# ---------------------------------------------------------------------------
# registry
# ---------------------------------------------------------------------------

OPS: Dict[str, ProtectedOp] = {}


def register_op(op: ProtectedOp) -> ProtectedOp:
    """Register an adapter; its name becomes a FaultReport key and a plan
    pattern."""
    OPS[op.name] = op
    register_op_kind(op.name)
    return op


def get_op(name: str) -> ProtectedOp:
    if name not in OPS:
        raise KeyError(f"unknown protected op {name!r}; "
                       f"registered: {sorted(OPS)}")
    return OPS[name]


QGEMM = register_op(QGemmOp())
FLOAT_GEMM = register_op(FloatGemmOp())
EMBEDDING_BAG = register_op(EmbeddingBagOp())

__all__ = ["Check", "ProtectedOp", "OPS", "register_op", "get_op",
           "QGemmOp", "FloatGemmOp", "EmbeddingBagOp", "QGEMM",
           "FLOAT_GEMM", "EMBEDDING_BAG", "LANE"]
