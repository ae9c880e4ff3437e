"""Beyond-paper: quantized KV cache with ABFT rowsum checksums (the JAX
package's ``core/abft_kvcache.py``).

The paper's recipe applied to the largest resident state of a serving
fleet:

  * **quantize** the cache like the paper quantizes embedding tables
    (§III-C): per-(position, head) int8 rows with (α, β) — half the bytes
    of a bf16 cache;
  * **checksum** it like the paper checksums embedding tables (Alg. 2):
    an int32 rowsum ``C_T[pos] = Σ_d k_q[pos, d]`` stored beside the
    cache, verified on every read.

Layout per layer (grouped KV layout of :mod:`repro_torch.layers.attention`):
    k_q, v_q          int8  [B, Kv, S, dh]
    k_a/k_b, v_a/v_b  f32   [B, Kv, S]     (per-row affine params)
    k_sum, v_sum      int32 [B, Kv, S]     (ABFT rowsums)

Verification (Eq. 5 with pool size 1, exact integer form): a read row is
corrupt iff ``Σ_d k_q[r, d] != k_sum[r]`` — pure int math, zero false
positives.

``alpha = span / 255`` is the IEEE quotient here, as the JAX function
computes it eagerly; under ``jax.jit`` XLA folds the division into a
multiply by the float32 reciprocal (ROADMAP §C5).  Every function is
functional, as in JAX: :func:`update_kv_row` returns new tensors, and a
row position past the cache is dropped, as a JAX scatter drops it.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class QuantKV(NamedTuple):
    q: torch.Tensor       # int8 [..., S, dh]
    alpha: torch.Tensor   # f32  [..., S]
    beta: torch.Tensor    # f32  [..., S]
    rowsum: torch.Tensor  # int32 [..., S]  (ABFT checksum, Alg. 2 style)


def quantize_kv_rows(x: torch.Tensor) -> QuantKV:
    """Per-row affine int8 quantization + rowsum checksum.

    x [..., S, dh] float -> QuantKV.  A zero row (the padding of a
    prefill cache) takes the 1e-12 span clamp: code -128 throughout and
    rowsum -128 * dh."""
    xf = x.to(torch.float32)
    xmin = torch.amin(xf, dim=-1)
    xmax = torch.amax(xf, dim=-1)
    span = torch.clamp(xmax - xmin, min=1e-12)
    # a tensor divisor: PyTorch divides by a Python scalar as a multiply
    # by its reciprocal, not the IEEE quotient
    alpha = span / torch.full_like(span, 255.0)
    beta = xmin + 128.0 * alpha
    q = torch.clamp(torch.round((xf - beta[..., None]) / alpha[..., None]),
                    -128, 127).to(torch.int8)
    rowsum = torch.sum(q, dim=-1, dtype=torch.int32)
    return QuantKV(q, alpha, beta, rowsum)


def dequantize_kv(kv: QuantKV, dtype=torch.bfloat16) -> torch.Tensor:
    return (kv.alpha[..., None] * kv.q.to(torch.float32)
            + kv.beta[..., None]).to(dtype)


def verify_kv(kv: QuantKV, valid_mask=None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact integer check: (err_rows bool [..., S], err_count int32).

    ``valid_mask`` [..., S] restricts the check to written positions."""
    got = torch.sum(kv.q, dim=-1, dtype=torch.int32)
    err = got != kv.rowsum
    if valid_mask is not None:
        err = err & valid_mask
    return err, torch.sum(err, dtype=torch.int32)


def set_rows(t: torch.Tensor, batch_idx: torch.Tensor, pos: torch.Tensor,
              rows: torch.Tensor) -> torch.Tensor:
    """``t.at[batch_idx, :, pos].set(rows)`` of JAX: a new tensor with row
    ``pos[b]`` of batch ``batch_idx[b]`` (every head) replaced.  The two
    index tensors are split by a slice, so the indexed dims come first:
    ``rows`` is ``[B, Kv, ...]``.  A position past the cache writes
    nothing (JAX drops an out-of-bounds scatter), with no host sync."""
    s = t.shape[2]
    keep = (pos < s).reshape((-1,) + (1,) * (rows.dim() - 1))
    posc = pos.clamp(max=s - 1).long()
    bidx = batch_idx.long()
    out = t.clone()
    out[bidx, :, posc] = torch.where(keep, rows.to(t.dtype),
                                     t[bidx, :, posc])
    return out


def update_kv_row(kv: QuantKV, batch_idx: torch.Tensor, pos: torch.Tensor,
                  new_row: torch.Tensor) -> QuantKV:
    """Decode-step cache append: quantize + checksum the new row.

    kv leaves [B, Kv, S, ...]; new_row [B, Kv, dh] float; pos [B]."""
    nq = quantize_kv_rows(new_row)                     # [B, Kv]
    return QuantKV(*(set_rows(old, batch_idx, pos, new)
                     for old, new in zip(kv, nq)))


def attend_quantized(q_heads: torch.Tensor, kv_k: QuantKV, kv_v: QuantKV,
                     pos: torch.Tensor, *, n_heads: int, n_kv: int,
                     verify: bool = True, window=None,
                     prefix_global: int = 0):
    """One-token decode attention straight off the int8 cache.

    q_heads [B, H, dh] (bf16/f32); kv_* int8 caches [B, Kv, S, *].
    Returns (out [B, H, dh] f32, err_count int32).

    ``window`` (sliding-window size) and ``prefix_global`` (always-visible
    prefix length) mirror the masking of
    :func:`repro_torch.layers.attention.attention_decode`.

    Scores expand affinely without dequantizing the whole cache:
        q·k_row = α_row (q·k_q_row) + β_row Σ_d q_d
    — the Eq. 1 decomposition the paper uses for GEMM, applied to
    attention.  The products are plain float32 ``torch.matmul``s (the
    JAX package leaves them to XLA; no kernel of its own)."""
    b, h, dh = q_heads.shape
    g = n_heads // n_kv
    s_max = kv_k.q.shape[2]
    qg = q_heads.reshape(b, n_kv, g, dh).to(torch.float32)
    kv_pos = torch.arange(s_max, device=pos.device)

    errs = torch.zeros((), dtype=torch.int32, device=pos.device)
    if verify:
        mask = kv_pos[None, None, :] <= pos[:, None, None]
        _, e1 = verify_kv(kv_k, mask)
        _, e2 = verify_kv(kv_v, mask)
        errs = e1 + e2

    # scores: affine expansion (the cache's codes in the contraction)
    qk_int = torch.matmul(qg, kv_k.q.to(torch.float32).transpose(-1, -2))
    qsum = torch.sum(qg, dim=-1)                         # [B, Kv, g]
    s = (kv_k.alpha[:, :, None, :] * qk_int
         + kv_k.beta[:, :, None, :] * qsum[..., None]) * dh ** -0.5

    kp = kv_pos[None, None, None, :]
    valid = kp <= pos[:, None, None, None]
    if window is not None:
        in_win = (pos[:, None, None, None] - kp) < window
        if prefix_global > 0:
            in_win |= kp < prefix_global
        valid &= in_win
    s = torch.where(valid, s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)                         # [B, Kv, g, S]

    # output: p @ V = Σ_s p_s (α_s v_q_s + β_s) — the same affine split
    pv_int = torch.matmul(p * kv_v.alpha[:, :, None, :],
                          kv_v.q.to(torch.float32))
    pbeta = torch.sum(p * kv_v.beta[:, :, None, :], dim=-1)   # [B, Kv, g]
    out = pv_int + pbeta[..., None]
    return out.reshape(b, h, dh), errs


__all__ = ["QuantKV", "quantize_kv_rows", "dequantize_kv", "verify_kv",
           "set_rows", "update_kv_row", "attend_quantized"]
