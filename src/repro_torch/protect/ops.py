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
through :mod:`repro_torch.kernels.ops`, ``float_gemm`` (a plain float32
product, as the JAX package leaves it to XLA) and ``kv_cache`` (the
checksummed int8 KV cache, plain PyTorch: the JAX package has no kernel
for it) and ``kv_cache_paged`` (the paged, page-checksummed cache of
:mod:`repro_torch.paging`, plain PyTorch too).

Scheme names carry over from JAX plans: ``pallas`` ("force the kernel")
is a synonym of the port's ``cuda`` scheme, and the EmbeddingBag's
``xla`` of its ``plain`` scheme.
"""
from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Protocol, Tuple, \
    runtime_checkable

import torch

from repro_torch.core import (EB_REL_BOUND, LANE, QuantKV, abft_gemm_f32,
                              attend_quantized, column_check,
                              correct_single_error, correct_weight_flip,
                              dequantize_kv, encode_weight_f32, int_matmul,
                              pack_encoded_b, quantize_kv_rows,
                              table_rowsums, update_kv_row, verify_rows)
from repro_torch.core.policy import register_op_kind
from repro_torch.kernels import ops as kops
from repro_torch.paging.cache import attend_paged, paged_append
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

    A stack of MoE experts (packed ``[E, k, n + LANE]``, A ``[E, m, k]``)
    is one call with one check per expert: the err count is an ``[E]``
    vector, so the report sums to what a JAX ``vmap`` over per-expert
    calls sums, and ``recompute`` keeps the re-run only for the experts
    that still report errors.

    A disabled rule runs :meth:`unprotected`: K1's unprotected instance
    on the card, the exact integer product on the CPU.
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
        if packed.dim() == 3:
            return self._experts(packed, colsum_ref, a_q, rule)
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

    def _experts(self, packed, colsum_ref, a_q, rule: ResolvedRule):
        """A stack of experts: the fused schemes in one batched call (one
        K1 launch an expert on the card); the unfused scheme and the
        ``correct`` policy's column checks one expert at a time."""
        scheme = rule.scheme or "packed"
        if scheme in ("packed", "plain", "cuda", "pallas") and \
                rule.policy != "correct":
            use_kernel = {"packed": None, "plain": False}.get(scheme, True)
            c, err_rows = kops.abft_qgemm(a_q, packed, use_kernel=use_kernel)
            return c, Check(torch.sum(err_rows, dim=-1, dtype=torch.int32),
                            err_rows.to(torch.bool))
        outs = [self(packed[e] if colsum_ref is None
                     else (packed[e], colsum_ref[e]), a_q[e], rule=rule)
                for e in range(packed.shape[0])]
        checks = [ck for _, ck in outs]
        return (torch.stack([c for c, _ in outs]),
                Check(torch.stack([ck.err_count for ck in checks]),
                      torch.stack([ck.err_mask for ck in checks]),
                      [ck.aux for ck in checks]))

    def unprotected(self, encoded, a_q):
        packed, _ = self._unpack(encoded)
        return kops.qgemm_unprotected(a_q, packed)

    def correct(self, out, check: Check):
        """Single-error repair; returns (fixed, residual_err, applied).

        Tries the single-cell accumulator repair first, then (when the
        encoded side carried a column-sum reference) the weight-flip
        repair.  The two cannot mis-fire together: a weight flip leaves
        the accumulator column deltas self-consistent (zero), and a clean
        B leaves the weight encodings self-consistent.
        """
        aux = check.aux
        if isinstance(aux, list):              # a stack of experts
            per = [self.correct(out[e], Check(check.err_count[e],
                                              check.err_mask[e], aux[e]))
                   for e in range(len(aux))]
            return tuple(torch.stack(t) for t in zip(*per))
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
        """K2's unprotected instance on the card, the plain gather on the
        CPU."""
        table_q, alphas, betas, _ = encoded
        return kops.embedding_bag_unprotected(table_q, alphas, betas,
                                              indices, weights)


# ---------------------------------------------------------------------------
# Quantized KV cache (beyond-paper)
# ---------------------------------------------------------------------------

class KvCacheOp:
    """Checksummed int8 KV cache: encoded = (kv_k, kv_v) QuantKV pair;
    inputs = (q_heads [B, H, dh], pos [B]); static n_heads/n_kv plus the
    window/prefix masking of ``layers.attention.attention_decode``."""
    name = "kv_cache"
    schemes = ("default",)
    supports_correct = False

    def encode(self, kv: torch.Tensor) -> QuantKV:
        """Float K/V rows ([..., S, dh]) -> QuantKV (quantize + checksum)."""
        return quantize_kv_rows(kv)

    def update(self, kv: QuantKV, batch_idx, pos, new_row) -> QuantKV:
        return update_kv_row(kv, batch_idx, pos, new_row)

    def __call__(self, encoded, q_heads, pos, *,
                 rule: ResolvedRule = _DEFAULT_RULE, n_heads: int,
                 n_kv: int, window=None, prefix_global: int = 0):
        kv_k, kv_v = encoded
        out, errs = attend_quantized(q_heads, kv_k, kv_v, pos,
                                     n_heads=n_heads, n_kv=n_kv,
                                     verify=True, window=window,
                                     prefix_global=prefix_global)
        return out, Check(errs)

    def unprotected(self, encoded, q_heads, pos, *, n_heads: int,
                    n_kv: int, window=None, prefix_global: int = 0):
        kv_k, kv_v = encoded
        out, _ = attend_quantized(q_heads, kv_k, kv_v, pos,
                                  n_heads=n_heads, n_kv=n_kv,
                                  verify=False, window=window,
                                  prefix_global=prefix_global)
        return out

    def dequantize(self, kv: QuantKV, dtype=torch.bfloat16):
        return dequantize_kv(kv, dtype)


# ---------------------------------------------------------------------------
# Paged quantized KV cache (repro_torch.paging)
# ---------------------------------------------------------------------------

class KvCachePagedOp:
    """Page-table int8 KV cache with per-page folded checksums.

    encoded = (pk, pv) :class:`repro_torch.paging.PagedKV` pair
    (per-layer layout); inputs = (q_heads [B, H, dh], pos [B]).
    Verify-on-touch: the check covers exactly the pages the attention mask
    reads, one int32 compare per (page, kv head), and the touched-page
    count rides the report's ``checks`` counter (``Check.aux["n_checks"]``)
    so telemetry can price verification per decode token.  Page repair
    (evict/rebuild/abort-owner) is a host-side allocator action — the
    serving engine interprets the plan policy; the op only counts, so
    call sites pass a log-policy rule (:func:`~repro_torch.protect.runtime.
    paged_kv_rule`)."""
    name = "kv_cache_paged"
    schemes = ("default",)
    supports_correct = False

    def encode(self, kv):
        """Pool encoding lives in :mod:`repro_torch.paging.cache`
        (pack_prompt_pages / paged_append); pass pools through."""
        return kv

    def append(self, pk, pos, new_rows):
        return paged_append(pk, pos, new_rows)

    def __call__(self, encoded, q_heads, pos, *,
                 rule: ResolvedRule = _DEFAULT_RULE, n_heads: int,
                 n_kv: int, window=None, prefix_global: int = 0):
        pk, pv = encoded
        out, errs, pages = attend_paged(q_heads, pk, pv, pos,
                                        n_heads=n_heads, n_kv=n_kv,
                                        verify=True, window=window,
                                        prefix_global=prefix_global)
        return out, Check(errs, aux={"n_checks": pages})

    def unprotected(self, encoded, q_heads, pos, *, n_heads: int,
                    n_kv: int, window=None, prefix_global: int = 0):
        pk, pv = encoded
        out, _, _ = attend_paged(q_heads, pk, pv, pos, n_heads=n_heads,
                                 n_kv=n_kv, verify=False, window=window,
                                 prefix_global=prefix_global)
        return out


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
KV_CACHE = register_op(KvCacheOp())
KV_CACHE_PAGED = register_op(KvCachePagedOp())

__all__ = ["Check", "ProtectedOp", "OPS", "register_op", "get_op",
           "QGemmOp", "FloatGemmOp", "EmbeddingBagOp", "KvCacheOp",
           "KvCachePagedOp", "QGEMM", "FLOAT_GEMM", "EMBEDDING_BAG",
           "KV_CACHE", "KV_CACHE_PAGED", "QuantKV", "LANE"]
