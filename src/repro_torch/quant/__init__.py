"""Affine quantization substrate (paper §III-A).

A real tensor ``x`` is represented by an integer tensor ``x_I`` plus
floating-point ``(alpha, beta)`` such that ``x ≈ alpha * x_I + beta``.
"""
from repro_torch.quant.qtensor import (
    QTensor,
    dequantize,
    int_matmul,
    qgemm_f32,
    quantize_channels,
    quantize_rows,
    quantize_tensor,
    requantize,
)

__all__ = [
    "QTensor",
    "quantize_tensor",
    "quantize_rows",
    "quantize_channels",
    "dequantize",
    "int_matmul",
    "qgemm_f32",
    "requantize",
]
