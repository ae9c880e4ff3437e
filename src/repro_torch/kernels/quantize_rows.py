"""CUDA kernel K3: per-row dynamic activation quantization (signed int8).

Replaces ``src/repro/kernels/quantize_rows.py::quantize_rows_pallas``.
Source: ``csrc/quantize_rows.cu``; plain version:
:func:`repro_torch.kernels.ref.quantize_rows_ref`.

What bounds it on the H100: its launch.  It reads 2 or 4 bytes and writes
1 per element (plus 8 per row) and does a handful of float operations per
element; on the serving paths one call moves at most 1.4 MB (64 RWKV rows
of 7168 bf16) and mostly under 30 KB (DLRM rows <= 1024 wide at m = 10),
under half a microsecond at 3.35 TB/s, while a launch in a stream costs
about two (1.76 us chained, measured on an H100 80GB HBM3 at 700 W;
``PERF.md``).

Design: one block of 256 threads per row -- a min/max reduction, then a
second pass that writes q, 16 bytes a thread where the rows are aligned,
from the words each thread loaded at once in the first pass and kept in
registers.  The input is float32 or bfloat16, converted
in registers (exactly), so the RWKV path hands its bf16 activations over
with no cast kernel in between.  The arithmetic is written with
round-to-nearest intrinsics, IEEE division and ``rintf``, so q, alpha and
beta are bit-exact with the plain version on the float32 cast of the same
input; that is what makes the GEMM's int32 output, and hence its checks,
equal on both paths.

The launch cost is hidden instead of shaved (Hopper's programmatic
dependent launch): every block of K3 executes
``griddepcontrol.launch_dependents`` first, and K1, the GEMM that consumes
q, is launched as its programmatic dependent (see
:mod:`repro_torch.kernels.abft_qgemm`), so K1's launch and prologue run
while K3 does.  K3 is itself launched as the dependent of the kernel
before it, and waits for that grid (``griddepcontrol.wait``) before it
touches global memory.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "quantize_rows"


@functools.cache
def _launch():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(_NAME, "quantize_rows_launch",
                        [p, i, p, p, p, i, i, i, p])


#: the input types the kernel reads
DTYPES = (torch.float32, torch.bfloat16)


def quantize_rows_cuda(x: torch.Tensor, *, pdl: bool = True):
    """f32 or bf16 [m, n] on the card -> (q int8 [m, n], alpha f32 [m],
    beta f32 [m]).

    ``x`` must be a contiguous float32 or bfloat16 CUDA tensor with
    ``n >= 1``; the caller casts any other type
    (``kernels.ops.quantize_rows`` does).  ``pdl=False`` launches K3 as a
    plain successor of the kernel before it, only to measure what
    programmatic dependent launch buys."""
    if not x.is_cuda:
        raise ValueError("quantize_rows_cuda needs a CUDA tensor")
    if x.dtype not in DTYPES or x.dim() != 2 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32 or bfloat16 "
                         f"[m, n], got {x.dtype} {tuple(x.shape)}")
    m, n = x.shape
    if n < 1 or m >= 2**31 or m * n >= 2**62:
        raise ValueError(f"unsupported shape {tuple(x.shape)}")
    q = torch.empty((m, n), dtype=torch.int8, device=x.device)
    alpha = torch.empty((m,), dtype=torch.float32, device=x.device)
    beta = torch.empty((m,), dtype=torch.float32, device=x.device)
    if m == 0:
        return q, alpha, beta
    with torch.cuda.device(x.device):
        err = _launch()(x.data_ptr(), int(x.dtype == torch.bfloat16),
                        q.data_ptr(), alpha.data_ptr(),
                        beta.data_ptr(), m, n, int(pdl),
                        torch.cuda.current_stream().cuda_stream)
    _build.check(_NAME, err)
    quantize_rows_cuda.launches += 1
    return q, alpha, beta


quantize_rows_cuda.launches = 0
