"""Timing of the campaign's overhead cells.

:func:`median_time` is the protected/unprotected pair's clock and
:func:`phase_breakdown` times a dict of named phase thunks (encode / gemm /
verify ...) the same way — the source of the artifact's
``overhead_breakdown`` column.  On the card each call is bracketed by CUDA
events and synchronised, so a time covers the call's launches and its
device work, which is what a server pays for one call; on the CPU, where
every operation is synchronous, by ``time.perf_counter``.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, Mapping

import numpy as np
import torch


def _call_seconds(fn: Callable, device: torch.device) -> float:
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3
    t0 = time.perf_counter()
    fn()
    return time.perf_counter() - t0


def median_time(fn: Callable, *, device: torch.device, warmup: int = 2,
                iters: int = 10, min_time_s: float = 0.2) -> float:
    """Median seconds per call of ``fn`` on ``device``: ``warmup`` calls,
    then at least ``iters`` calls and ``min_time_s`` in all (at most 100
    calls)."""
    for _ in range(warmup):
        fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    times, total = [], 0.0
    while total < min_time_s or len(times) < iters:
        dt = _call_seconds(fn, device)
        times.append(dt)
        total += dt
        if len(times) >= 100:
            break
    return float(np.median(times))


def phase_breakdown(phases: Mapping[str, Callable], *,
                    device: torch.device, warmup: int = 2, iters: int = 5,
                    min_time_s: float = 0.05, tracer=None,
                    **span_args) -> Dict[str, float]:
    """Median seconds per named phase thunk, in mapping order (shorter
    defaults than :func:`median_time`: the breakdown is a per-cell column,
    not the headline overhead number).  With a ``tracer``, each phase also
    lands as an accounting span (cat ``"overhead"``, duration = the
    median) next to the cell's build/trials spans."""
    out: Dict[str, float] = {}
    for name, fn in phases.items():
        t0 = tracer.now_s() if tracer is not None else 0.0
        out[name] = median_time(fn, device=device, warmup=warmup,
                                iters=iters, min_time_s=min_time_s)
        if tracer is not None:
            tracer.add_span(f"phase:{name}", cat="overhead", start_s=t0,
                            dur_s=out[name], **span_args)
    return out
