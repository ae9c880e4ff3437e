"""Quantized tensors and the Eq. (1) quantized GEMM pipeline (the JAX
package's ``quant/qtensor.py``).

Paper convention (§III-A): ``x ≈ alpha * x_I + beta`` where ``x_I`` is an
8-bit integer.  Activations (matrix A) are quantized to *unsigned* 8-bit with
a per-row dynamic range; weights (matrix B) to *signed* 8-bit, symmetric
(beta = 0) per output channel, which is the FBGEMM/DLRM deployment default.

The quantized matrix product (Eq. 1) is::

    AB ≈ aA*aB * (A_I @ B_I)
       + aA*bB * (A_I @ e) e^T
       + aB*bA * e (e^T @ B_I)
       + k*bA*bB * e e^T

i.e. the int32 product ``C_temp = A_I @ B_I`` plus rank-1 corrections.
ABFT (:mod:`repro_torch.core.abft_gemm`) verifies ``C_temp`` *before*
requantization (§IV-B: requantization is non-linear, checksums cannot
survive it).

Rounding is half to even (``torch.round``, like ``jnp.round``), and every
division is by a tensor: on the card PyTorch divides by a Python scalar
as a multiply by its reciprocal, which is not the IEEE quotient.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.abft_gemm import int_matmul

INT8_MIN, INT8_MAX = -128, 127
UINT8_MAX = 255


@dataclasses.dataclass
class QTensor:
    """An integer tensor with affine dequantization parameters.

    ``values`` has an integer dtype; ``alpha``/``beta`` broadcast against the
    value tensor along ``axis`` (None => per-tensor scalars).
    """

    values: torch.Tensor         # int8 / uint8
    alpha: torch.Tensor          # f32, scalar or per-row/per-channel
    beta: torch.Tensor           # f32, same shape as alpha
    axis: Optional[int] = None   # axis the (alpha, beta) pairs index

    @property
    def shape(self):
        return self.values.shape

    @property
    def dtype(self):
        return self.values.dtype


def _expand(param: torch.Tensor, ndim: int,
            axis: Optional[int]) -> torch.Tensor:
    """Broadcast a per-axis parameter vector against an ndim tensor."""
    if axis is None:
        return param
    shape = [1] * ndim
    shape[axis] = -1
    return param.reshape(shape)


def quantize_tensor(x: torch.Tensor, *, unsigned: bool = False) -> QTensor:
    """Per-tensor affine quantization of ``x`` into 8 bits."""
    return _quantize(x, axis=None, unsigned=unsigned)


def quantize_rows(x: torch.Tensor, *, unsigned: bool = True) -> QTensor:
    """Per-row dynamic quantization (activation matrices; paper's A)."""
    return _quantize(x, axis=0, unsigned=unsigned)


def quantize_channels(w: torch.Tensor, *,
                      unsigned: bool = False) -> QTensor:
    """Per-output-channel (column) symmetric quantization (weights; paper's
    B).  Symmetric: beta = 0 keeps the rank-1 correction terms cheap and the
    int32 accumulator centered."""
    amax = torch.amax(torch.abs(w), dim=0)
    alpha = torch.clamp(amax, min=1e-12) / torch.full_like(amax, INT8_MAX)
    q = torch.clamp(torch.round(w / alpha[None, :]), INT8_MIN, INT8_MAX)
    alpha = alpha.to(torch.float32)
    return QTensor(q.to(torch.int8), alpha, torch.zeros_like(alpha), axis=1)


def _quantize(x: torch.Tensor, *, axis: Optional[int],
              unsigned: bool) -> QTensor:
    reduce_dims = tuple(i for i in range(x.dim()) if axis is None or i != axis)
    xmin = torch.amin(x, dim=reduce_dims)
    xmax = torch.amax(x, dim=reduce_dims)
    lo, hi = (0, UINT8_MAX) if unsigned else (INT8_MIN, INT8_MAX)
    span = torch.clamp(xmax - xmin, min=1e-12)
    alpha = span / torch.full_like(span, hi - lo)
    beta = xmin - lo * alpha
    a = _expand(alpha, x.dim(), axis)
    b = _expand(beta, x.dim(), axis)
    q = torch.clamp(torch.round((x - b) / a), lo, hi)
    dtype = torch.uint8 if unsigned else torch.int8
    return QTensor(q.to(dtype), alpha.to(torch.float32),
                   beta.to(torch.float32), axis=axis)


def dequantize(q: QTensor) -> torch.Tensor:
    a = _expand(q.alpha, q.values.dim(), q.axis)
    b = _expand(q.beta, q.values.dim(), q.axis)
    return a * q.values.to(torch.float32) + b


def qgemm_f32(a: QTensor, b: QTensor,
              c_temp: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full Eq. (1) pipeline: int32 product + rank-1 corrections -> f32.

    ``c_temp`` may be supplied when the caller already computed the int32
    product (e.g. through the ABFT-verified path) so the correction terms
    reuse it.  Otherwise :func:`int_matmul` (``core.int_matmul``: a plain
    exact product, as the JAX package leaves it to XLA outside any
    kernel) computes it.
    """
    m, k = a.values.shape
    n = b.values.shape[1]
    if c_temp is None:
        c_temp = int_matmul(a.values, b.values)
    a_alpha = a.alpha if a.axis == 0 else a.alpha.expand(m)
    a_beta = a.beta if a.axis == 0 else a.beta.expand(m)
    b_alpha = b.alpha if b.axis == 1 else b.alpha.expand(n)
    b_beta = b.beta if b.axis == 1 else b.beta.expand(n)

    out = (a_alpha[:, None] * b_alpha[None, :]) * c_temp.to(torch.float32)
    # + aA*bB * (A_I @ e_k) e_n^T   (row sums of A)
    a_rows = torch.sum(a.values.to(torch.int32), dim=1).to(torch.float32)
    out = out + (a_alpha * a_rows)[:, None] * b_beta[None, :]
    # + aB*bA * e_m (e_k^T @ B_I)   (col sums of B)
    b_cols = torch.sum(b.values.to(torch.int32), dim=0).to(torch.float32)
    out = out + a_beta[:, None] * (b_alpha * b_cols)[None, :]
    # + k*bA*bB
    out = out + k * a_beta[:, None] * b_beta[None, :]
    return out


def requantize(x: torch.Tensor, *, unsigned: bool = False) -> QTensor:
    """Requantization ``Q`` of a float matrix into 8 bits (Fig. 1 last
    stage)."""
    return quantize_rows(x, unsigned=unsigned)
