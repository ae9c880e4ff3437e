"""The operator surface over the four kernels (and the two unprotected
instances the overhead benchmarks time), with one dispatch rule.

A CUDA tensor takes the hand-written kernel; a CPU tensor takes the plain
PyTorch version.  An explicit ``use_kernel`` always wins: ``False`` takes
the plain version on any device (the JAX package's precedence rule for
``use_pallas=False``), and ``True`` on a CPU tensor raises — a CUDA kernel
has no interpret mode, and nothing falls back silently.

The :mod:`repro_torch.protect` adapters dispatch here; layer code should
not call these directly.  :func:`qgemm_unprotected` and
:func:`embedding_bag_unprotected` are what a disabled plan rule runs
(the adapters' ``unprotected``) and the overhead benchmarks' baselines.

K1 and its unprotected instance also take a stack of MoE experts:
``A [E, m, k]`` against ``B' [E, k, n + 128]``, each expert's rows on
its own weights.  On the card that is one launch an expert, each
writing its slice of one output; the plain version is one batched
product.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import AbftEbOut, EB_REL_BOUND, LANE, verify_bags
from repro_torch.kernels import ref as _ref


def _use_kernel(use_kernel: Optional[bool], x: torch.Tensor) -> bool:
    if use_kernel is None:
        return x.is_cuda
    if use_kernel and not x.is_cuda:
        raise ValueError("the CUDA kernel needs CUDA tensors; pass "
                         "use_kernel=False (or leave it unset) on the CPU")
    return bool(use_kernel)


def _per_expert(launch, a_q: torch.Tensor,
                b_packed: torch.Tensor) -> torch.Tensor:
    """A stack of experts on the card: ``launch(a, b, c, e)`` once an
    expert, each writing expert ``e``'s slice ``c`` of one int32 output
    ``[E, m, n]``, which is returned."""
    a_q, b_packed = a_q.contiguous(), b_packed.contiguous()
    n_exp, m, _ = a_q.shape
    c = torch.empty((n_exp, m, b_packed.shape[-1] - LANE),
                    dtype=torch.int32, device=a_q.device)
    for e in range(n_exp):
        launch(a_q[e], b_packed[e], c[e], e)
    return c


def abft_qgemm(a_q: torch.Tensor, b_packed: torch.Tensor, *,
               use_kernel: Optional[bool] = None,
               with_colcheck: bool = False):
    """ABFT int8 GEMM against a packed B'. -> (C int32, err_rows int32 [m]),
    plus the exact int32 column check ``colsum(A) @ B`` with
    ``with_colcheck`` (what the ``correct`` policy consumes)."""
    if b_packed.dim() == 3:
        if with_colcheck:
            raise ValueError("the column check takes one weight, not a "
                             "stack of experts")
        if not _use_kernel(use_kernel, a_q):
            return _ref.abft_qgemm_ref(a_q, b_packed)
        from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
        err = torch.empty(a_q.shape[:2], dtype=torch.int32,
                          device=a_q.device)
        c = _per_expert(lambda a, b, c_e, e: abft_qgemm_cuda(
            a, b, out=(c_e, err[e])), a_q, b_packed)
        return c, err
    if _use_kernel(use_kernel, a_q):
        from repro_torch.kernels.abft_qgemm import abft_qgemm_cuda
        return abft_qgemm_cuda(a_q.contiguous(), b_packed.contiguous(),
                               with_colcheck=with_colcheck)
    return _ref.abft_qgemm_ref(a_q, b_packed, with_colcheck=with_colcheck)


def qgemm_unprotected(a_q: torch.Tensor, b_packed: torch.Tensor, *,
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """``C = A @ B'[:, :n]`` (int32), the protected GEMM's C without its
    check: K1's unprotected instance on the card (int8 or uint8 A), the
    exact integer product on the CPU.  A stack of experts as in
    :func:`abft_qgemm`."""
    if not _use_kernel(use_kernel, a_q):
        return _ref.qgemm_ref(a_q, b_packed)
    from repro_torch.kernels.abft_qgemm import qgemm_unprotected_cuda
    if b_packed.dim() == 2:
        return qgemm_unprotected_cuda(a_q.contiguous(), b_packed.contiguous())
    return _per_expert(lambda a, b, c_e, e: qgemm_unprotected_cuda(
        a, b, out=c_e), a_q, b_packed)


def embedding_bag_unprotected(table_q, alphas, betas, indices, weights=None,
                              *, use_kernel: Optional[bool] = None
                              ) -> torch.Tensor:
    """The EmbeddingBag's R without its check: K2's unprotected instance
    on the card, the plain gather on the CPU.  Takes one table (``[rows,
    d]``, ``indices [bags, pool]``) or a stack (``[tables, rows, d]``,
    ``indices [tables, bags, pool]``)."""
    if table_q.dim() == 2:
        return embedding_bag_unprotected(
            table_q[None], alphas[None], betas[None], indices[None],
            None if weights is None else weights[None],
            use_kernel=use_kernel)[0]
    if _use_kernel(use_kernel, table_q):
        from repro_torch.kernels.abft_embeddingbag import eb_unprotected_cuda
        return eb_unprotected_cuda(
            table_q, alphas, betas, indices.to(torch.int32).contiguous(),
            None if weights is None else weights.contiguous())
    return _ref.eb_ref(table_q, alphas, betas, indices, weights)


def abft_embedding_bag(table_q, alphas, betas, indices, rowsums,
                       weights=None, *, rel_bound: float = EB_REL_BOUND,
                       use_kernel: Optional[bool] = None) -> AbftEbOut:
    """EB forward + Eq. (5) check. -> AbftEbOut(r, err_bags, err_count).

    Takes one table (``[rows, d]``, ``indices [bags, pool]``; err_count
    is a scalar) or a stack (``[tables, rows, d]``, ``[tables, bags,
    pool]``; err_count is a ``[tables]`` vector, one check per table).
    On the card the whole call is K2, which makes the compare of
    :func:`repro_torch.core.verify_bags` itself (its terms summed in slot
    order); the plain path calls ``verify_bags``."""
    stacked = table_q.dim() == 3
    if not stacked:
        out = abft_embedding_bag(table_q[None], alphas[None], betas[None],
                                 indices[None], rowsums[None],
                                 None if weights is None else weights[None],
                                 rel_bound=rel_bound, use_kernel=use_kernel)
        return AbftEbOut(out.r[0], out.err_bags[0], out.err_count[0])
    if _use_kernel(use_kernel, table_q):
        # one kernel: the gather, R, rsum, the Eq. (5) compare (verify_bags'
        # terms in slot order) and the per-table count
        from repro_torch.kernels.abft_embeddingbag import abft_eb_cuda
        r, _, err_bags, err_count = abft_eb_cuda(
            table_q, alphas, betas, indices.to(torch.int32).contiguous(),
            rowsums, None if weights is None else weights.contiguous(),
            rel_bound=rel_bound)
        return AbftEbOut(r, err_bags, err_count)
    r, rsum = _ref.abft_eb_ref(table_q, alphas, betas, indices, weights)
    # ONE Eq. (5) definition for the plain path: the tables are flattened
    # into one row space so a single verify_bags call checks every bag
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

    The kernel reads float32 and bfloat16 as they are (its bf16 -> f32
    conversion is exact, in registers); any other type is cast to float32
    first.  The plain path casts to float32, as the JAX wrapper does."""
    if _use_kernel(use_kernel, x):
        from repro_torch.kernels.quantize_rows import DTYPES, \
            quantize_rows_cuda
        if x.dtype not in DTYPES:
            x = x.to(torch.float32)
        return quantize_rows_cuda(x.contiguous())
    return _ref.quantize_rows_ref(x)


def wkv_chunked(rh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                lwh: torch.Tensor, u: torch.Tensor, state: torch.Tensor, *,
                chunk: int = 16, use_kernel: Optional[bool] = None):
    """Chunked WKV6 forward. -> (y [B, S, H, dh], new_state [B, H, dh, dh]),
    both float32 (see :func:`repro_torch.kernels.ref.wkv_chunked_ref` for
    the math); the caller keeps ``chunk`` inside the f32 envelope.

    ``lwh``, ``u`` and ``state`` are float32.  The kernel reads r, k and v
    in float32 or bfloat16 as they are (bf16 -> f32 is exact); any other
    type, or a bf16 head width it cannot copy in 4-byte units, is cast to
    float32 first.  The plain path casts to float32, as the JAX layer
    does.

    K4 has no backward (nor has the JAX package's Pallas kernel): handed
    an input that requires grad while autograd records, this raises on
    every device, where the kernel would return a result with no
    gradient.  Training takes its plain version by name."""
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (rh, kh, vh, lwh, u, state)):
        raise RuntimeError(
            "wkv_chunked (kernel K4) has no backward: train through "
            "repro_torch.kernels.ref.wkv_chunked_ref")
    if _use_kernel(use_kernel, rh):
        from repro_torch.kernels.wkv6_chunked import takes, \
            wkv6_chunked_cuda
        rkv = ((rh, kh, vh) if takes(rh, kh, vh) else
               (t.to(torch.float32) for t in (rh, kh, vh)))
        return wkv6_chunked_cuda(*(t.contiguous() for t in rkv),
                                 lwh.contiguous(), u.contiguous(),
                                 state.contiguous(), chunk=chunk)
    return _ref.wkv_chunked_ref(rh, kh, vh, lwh, u, state, chunk=chunk)
