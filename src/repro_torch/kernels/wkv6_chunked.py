"""CUDA kernel K4: the chunked WKV6 forward of RWKV6 prefill.

Replaces ``src/repro/kernels/wkv6_chunked.py::wkv_chunked_pallas``.
Source: ``csrc/wkv6_chunked.cu``; plain version:
:func:`repro_torch.kernels.ref.wkv_chunked_ref`.

What bounds it on the H100: bytes, at the prefill shapes.  It must read
r, k, v and lw ([B, S, H, dh] float32 each) and the initial state, and
write y and the final state: 3.7 MB for one 64-token prompt of the
full-width model, against ~42 MFLOP of float32 work (about 11 FLOP per
byte, far below the card's ~20 FLOP per byte of float32 CUDA-core
peak).  Nothing between chunks leaves the block.

Design: one block of 256 threads per (batch, head) walks the chunks in
order; the ``dh x dh`` state stays in shared memory across chunks (the
TPU kernel's sequential grid axis becomes this loop, and its VMEM
scratch the shared tile).  Per chunk, the r/k/v/lw tiles, the decayed
operands and the ``C x C`` score tile sit in shared memory and the four
small products run as float32 FMAs on the CUDA cores.  This first
version leaves the card mostly idle at batch 1 (32 blocks for 132 SMs)
and does not use the tensor cores; both are later work.  The sums run
in another order than the plain version's, so the two agree within the
JAX tests' 2e-4, not bit for bit.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

_NAME = "wkv6_chunked"
#: the kernel's tile limits (``csrc/wkv6_chunked.cu``); a chunk of 16 is
#: also the float32 envelope ``chunk * |LOG_W_MIN| <= 80``
MAX_DH = 64
MAX_CHUNK = 16


@functools.cache
def _launch():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(_NAME, "wkv6_chunked_launch",
                        [p, p, p, p, p, p, p, p, i, i, i, i, i, p])


def wkv6_chunked_cuda(rh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                      lwh: torch.Tensor, u: torch.Tensor,
                      state: torch.Tensor, *, chunk: int = 16):
    """Run the chunked WKV6 forward on the card.

    ``rh``, ``kh``, ``vh``, ``lwh`` float32 [B, S, H, dh] (``lwh`` the log
    decay, clamped to [LOG_W_MIN, 0] by the caller); ``u`` float32 [H, dh];
    ``state`` float32 [B, H, dh, dh].  All contiguous, on one CUDA device,
    with ``dh <= 64``, ``chunk <= 16`` and ``S % chunk == 0``.  Returns
    ``(y [B, S, H, dh], new_state [B, H, dh, dh])``."""
    ts = (rh, kh, vh, lwh, u, state)
    dev = rh.device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError("wkv6_chunked_cuda needs every input on one CUDA "
                         "device")
    if not all(t.dtype == torch.float32 and t.is_contiguous() for t in ts):
        raise TypeError("wkv6_chunked_cuda needs contiguous float32 inputs")
    if rh.dim() != 4 or any(t.shape != rh.shape for t in (kh, vh, lwh)):
        raise ValueError("r, k, v, lw must share one [B, S, H, dh] shape")
    b, s, h, dh = rh.shape
    if u.shape != (h, dh) or state.shape != (b, h, dh, dh):
        raise ValueError(f"u must be [H, dh] and state [B, H, dh, dh] for "
                         f"r {tuple(rh.shape)}; got {tuple(u.shape)}, "
                         f"{tuple(state.shape)}")
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head width {dh} outside the kernel's 1..{MAX_DH}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} is outside the kernel's f32 "
                         f"envelope (1..{MAX_CHUNK})")
    if s % chunk:
        raise ValueError(f"sequence length {s} is not a multiple of "
                         f"chunk={chunk}")
    if b * h >= 2**31 or rh.numel() >= 2**62:
        raise ValueError(f"unsupported shape {tuple(rh.shape)}")
    y = torch.empty_like(rh)
    new_state = torch.empty_like(state)
    if b * h == 0:
        return y, new_state
    with torch.cuda.device(dev):
        rc = _launch()(rh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                       lwh.data_ptr(), u.data_ptr(), state.data_ptr(),
                       y.data_ptr(), new_state.data_ptr(), b, s, h, dh,
                       chunk, torch.cuda.current_stream().cuda_stream)
    _build.check(_NAME, rc)
    wkv6_chunked_cuda.launches += 1
    return y, new_state


wkv6_chunked_cuda.launches = 0
