"""CUDA kernel K4: the chunked WKV6 forward of RWKV6 prefill.

Replaces ``src/repro/kernels/wkv6_chunked.py::wkv_chunked_pallas``.
Source: ``csrc/wkv6_chunked.cu``; plain version:
:func:`repro_torch.kernels.ref.wkv_chunked_ref`.

What bounds it on the H100: latency.  Its bytes (r, k, v and lw
[B, S, H, dh] read once, y written once, the state read and written once:
3.7 MB for one 64-token prompt of the full-width model in float32) take
~1.1 microseconds at 3.35 TB/s, and its ~42 MFLOP of float32
work less; but each head walks its chunks in order, and each chunk is a
short chain of dependent phases.

Design: the state update and the output are separable along the value
dimension, so the grid is ``(B * H, dh / DV)`` with DV = 16 at dh = 64:
each block of 512 threads owns ``S[:, c0:c0+DV]`` in shared memory from
the first chunk to the last (the TPU kernel's sequential grid axis
becomes this loop) and the y columns of its slice.  At the prefill shape
(B 1, H 32, dh 64) that is 128 blocks, one wave on 132 SMs.  Per chunk
every block recomputes the state-independent values (the cumulative
decay, the decayed r and k, the diagonal and the ``C x C`` score tile)
from the full r, k and lw tiles; sharing them among a head's blocks as a
thread-block cluster measured slower (H100 80GB HBM3, 700 W;
``PERF.md``).  The next chunk's tiles are copied with ``cp.async`` into a
second staging slot while the current one computes; the decay scan runs
over the whole block; a chunk takes three barriers (the state is
double-buffered, so its update runs beside y's product and the score
tile); the loops stay compact; the products are float32 FMAs (TF32 would
not hold 2e-4).  r, k and v are read in their own type, float32 or
bfloat16 (bf16 -> f32 is exact), so the RWKV path casts nothing before
the launch.  Every sum runs in key or token order, so the outputs do not
depend on the grid; the plain version's matrix products sum in another
order, so the two agree within the JAX tests' 2e-4, not bit for bit.

:func:`wkv_plan` makes the launch plan on the host, so the CPU tests
check it; the C entry checks it again.  A shape the kernel does not take
raises.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.kernels import _build

_NAME = "wkv6_chunked"
#: the kernel's tile limits (``csrc/wkv6_chunked.cu``); a chunk of 16 is
#: also the float32 envelope ``chunk * |LOG_W_MIN| <= 80``
MAX_DH = 64
MAX_CHUNK = 16
MAX_DV = 16
#: the types r, k and v may have (lw, u and the state are float32)
DTYPES = (torch.float32, torch.bfloat16)


class WkvPlan(NamedTuple):
    dv: int             # value columns a block owns (divides dh, <= 16)
    grid: Tuple[int, int]   # (B * H, dh // dv)
    vec: int            # bytes a cp.async copies: 16, or 4 where rows or
                        # pointers are not 16-byte multiples
    smem_bytes: int     # dynamic shared memory: two staging slots

    @property
    def blocks(self) -> int:
        return self.grid[0] * self.grid[1]


def wkv_plan(b: int, h: int, dh: int, chunk: int, *, seq: int = 0,
             itemsize: int = 4, aligned: bool = True) -> WkvPlan:
    """The launch of K4 on r, k, v of ``itemsize`` bytes (4 for float32, 2
    for bfloat16) shaped [b, seq, h, dh], with ``aligned`` when r, k, v
    and lw start on 16-byte boundaries.  Raises ``ValueError`` for a shape
    the kernel does not take."""
    if not 1 <= dh <= MAX_DH:
        raise ValueError(f"head width {dh} outside the kernel's 1..{MAX_DH}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk={chunk} is outside the kernel's f32 "
                         f"envelope (1..{MAX_CHUNK})")
    if seq < 0 or seq % chunk:
        raise ValueError(f"sequence length {seq} is not a multiple of "
                         f"chunk={chunk}")
    if b < 0 or h < 0 or b * h >= 2**31:
        raise ValueError(f"unsupported batch {b} x heads {h}")
    if itemsize not in (2, 4):
        raise ValueError(f"r, k, v must be float32 or bfloat16, not "
                         f"{itemsize}-byte elements")
    if itemsize == 2 and dh % 2:
        raise ValueError(f"bfloat16 r, k, v need an even head width (4-byte "
                         f"copies), got {dh}")
    dv = next(d for d in (MAX_DV, 8, 4, 2, 1) if dh % d == 0)
    widths = (dh * itemsize, dh * 4, dv * itemsize)     # staged row bytes
    vec = 16 if aligned and all(w % 16 == 0 for w in widths) else 4
    # a slot: r and k (itemsize) and lw (4) over dh keys, v over dv values
    slot = -(-chunk * (2 * dh * itemsize + 4 * dh + dv * itemsize)
             // 16) * 16
    return WkvPlan(dv, (b * h, dh // dv), vec, 2 * slot)


def takes(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> bool:
    """Whether the kernel reads r, k and v in their own type: one type of
    :data:`DTYPES`, and an even head width for bfloat16."""
    return (r.dtype in DTYPES and k.dtype == r.dtype and v.dtype == r.dtype
            and (r.dtype == torch.float32 or r.shape[-1] % 2 == 0))


@functools.cache
def _launch():
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(_NAME, "wkv6_chunked_launch",
                        [p, p, p, p, p, p, p, p, i, i, i, i, i, i, i, i, i,
                         p])


def wkv6_chunked_cuda(rh: torch.Tensor, kh: torch.Tensor, vh: torch.Tensor,
                      lwh: torch.Tensor, u: torch.Tensor,
                      state: torch.Tensor, *, chunk: int = 16,
                      plan: Optional[WkvPlan] = None):
    """Run the chunked WKV6 forward on the card.

    ``rh``, ``kh``, ``vh`` float32 or bfloat16 (one type) [B, S, H, dh];
    ``lwh`` float32 [B, S, H, dh] (the log decay, clamped to
    [LOG_W_MIN, 0] by the caller); ``u`` float32 [H, dh]; ``state`` float32
    [B, H, dh, dh].  All contiguous, on one CUDA device, with ``dh <= 64``,
    ``chunk <= 16`` and ``S % chunk == 0``.  Returns float32
    ``(y [B, S, H, dh], new_state [B, H, dh, dh])``.  ``plan`` replaces
    :func:`wkv_plan`'s choice (to measure it); the C entry refuses one
    that does not fit."""
    ts = (rh, kh, vh, lwh, u, state)
    dev = rh.device
    if not all(t.is_cuda and t.device == dev for t in ts):
        raise ValueError("wkv6_chunked_cuda needs every input on one CUDA "
                         "device")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("wkv6_chunked_cuda needs contiguous inputs")
    if not takes(rh, kh, vh) or not all(t.dtype == torch.float32
                                        for t in (lwh, u, state)):
        raise TypeError(f"wkv6_chunked_cuda needs r, k, v of one type of "
                        f"{DTYPES} (an even head width in bf16) and float32 "
                        f"lw, u, state; got {[t.dtype for t in ts]}")
    if rh.dim() != 4 or any(t.shape != rh.shape for t in (kh, vh, lwh)):
        raise ValueError("r, k, v, lw must share one [B, S, H, dh] shape")
    b, s, h, dh = rh.shape
    if u.shape != (h, dh) or state.shape != (b, h, dh, dh):
        raise ValueError(f"u must be [H, dh] and state [B, H, dh, dh] for "
                         f"r {tuple(rh.shape)}; got {tuple(u.shape)}, "
                         f"{tuple(state.shape)}")
    if rh.numel() >= 2**62:
        raise ValueError(f"unsupported shape {tuple(rh.shape)}")
    if plan is None:
        plan = wkv_plan(b, h, dh, chunk, seq=s, itemsize=rh.element_size(),
                        aligned=all(t.data_ptr() % 16 == 0
                                    for t in (rh, kh, vh, lwh)))
    y = torch.empty(rh.shape, dtype=torch.float32, device=dev)
    new_state = torch.empty_like(state)
    if b * h == 0:
        return y, new_state
    with torch.cuda.device(dev):
        rc = _launch()(rh.data_ptr(), kh.data_ptr(), vh.data_ptr(),
                       lwh.data_ptr(), u.data_ptr(), state.data_ptr(),
                       y.data_ptr(), new_state.data_ptr(),
                       int(rh.dtype == torch.bfloat16), b, s, h, dh, chunk,
                       plan.dv, plan.vec, plan.smem_bytes,
                       torch.cuda.current_stream().cuda_stream)
    _build.check(_NAME, rc)
    wkv6_chunked_cuda.launches += 1
    return y, new_state


wkv6_chunked_cuda.launches = 0
