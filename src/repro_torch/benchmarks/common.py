"""Shared pieces of the overhead benchmarks: the shape set, the timers,
alternating rounds, and the table output."""
from __future__ import annotations

import statistics
import subprocess
import time
from typing import Callable, Dict, List, Sequence

import torch

from repro_torch.campaign.spec import DLRM_GEMM_SHAPES as GEMM_SHAPES

#: H100 SXM: L2 cache, HBM rate and dense peaks (NVIDIA's data sheet, at
#: the full 700 W power limit); float32 is outside the tensor cores
L2_BYTES = 50 * 2**20
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_OPS_PER_S = 989e12
F32_OPS_PER_S = 67e12
#: link rates a card sends at: NVLink 4 within an 8-card host (450 GB/s
#: each way, NVIDIA's H100 SXM data sheet) and one 400 Gb/s NDR
#: InfiniBand adapter a card between hosts (50 GB/s, NVIDIA's DGX H100
#: reference architecture)
NVLINK_BYTES_PER_S = 450e9
NETWORK_BYTES_PER_S = 50e9
#: rounds of alternating protected / unprotected timings a cell takes
ROUNDS = 5


class Timer:
    """Device time of a sequence of launches, by CUDA events.

    The launches are enqueued behind a spin kernel long enough to cover
    their host-side enqueue, so they run back to back and the events
    bracket device time only, not the host's launch gaps."""

    clock = "device"

    def __init__(self):
        s, e = self._events()
        s.record()
        torch.cuda._sleep(20_000_000)
        e.record()
        torch.cuda.synchronize()
        self.cycles_per_ms = 20_000_000 / s.elapsed_time(e)

    @staticmethod
    def _events():
        ev = torch.cuda.Event
        return ev(enable_timing=True), ev(enable_timing=True)

    def ms(self, fn: Callable[[], object], n: int = 20) -> float:
        """Milliseconds a call of ``fn`` takes on the card, over ``n``
        back-to-back calls."""
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        s, e = self._events()
        torch.cuda._sleep(int(self.cycles_per_ms * (1.5 * host_ms + 1.0)))
        s.record()
        for _ in range(n):
            fn()
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / n


class HostTimer:
    """Host wall time of ``n`` calls on the CPU: what the plain versions
    take there, never a device figure."""

    clock = "host"

    def ms(self, fn: Callable[[], object], n: int = 20) -> float:
        fn()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        return (time.perf_counter() - t0) * 1e3 / n


def make_timer(device: torch.device):
    return Timer() if device.type == "cuda" else HostTimer()


def alternate(timer, variants: Dict[str, Callable[[], object]], n: int
              ) -> Dict[str, List[float]]:
    """Time every variant once a round, :data:`ROUNDS` times, the order
    reversed every other round so that no variant always runs first.
    -> {name: [ms per call, one per round]}."""
    names = list(variants)
    out: Dict[str, List[float]] = {k: [] for k in names}
    for r in range(ROUNDS):
        for k in (names if r % 2 == 0 else names[::-1]):
            out[k].append(timer.ms(variants[k], n))
    return out


def spread(xs: Sequence[float]) -> dict:
    """Median, least and most of a list of per-round figures."""
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def overhead(prot: Sequence[float], unprot: Sequence[float]) -> dict:
    """``protected / unprotected - 1`` per round (the two timed in the same
    round, one after the other), as :func:`spread`."""
    return spread([p / u - 1.0 for p, u in zip(prot, unprot)])


def bound_ms(n_bytes: float, ops: float, ops_rate: float) -> tuple:
    """The least time the card could take, ``(ms, by)``: bytes over HBM's
    rate or operations over the peak, whichever is larger, and which of
    the two (``"bytes"`` or ``"operations"``) it is."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_rate * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def device_info(device: torch.device) -> dict:
    """The device the figures were taken on (the card's name and power
    limit as ``nvidia-smi`` gives them, or the CPU)."""
    if device.type != "cuda":
        return {"platform": "cpu", "clock": "host"}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    return {"platform": "gpu", "clock": "device",
            "kind": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def pct(x) -> str:
    return "—" if x is None else f"{100.0 * x:+.2f}%"


def markdown(title: str, header: Sequence[str], rows: Sequence[Sequence]
             ) -> str:
    lines = [f"# {title}", "", "| " + " | ".join(header) + " |",
             "|" + "---|" * len(header)]
    lines += ["| " + " | ".join(str(v) for v in row) + " |" for row in rows]
    return "\n".join(lines + [""])


__all__ = ["GEMM_SHAPES", "L2_BYTES", "HBM_BYTES_PER_S", "INT8_OPS_PER_S",
           "BF16_OPS_PER_S", "F32_OPS_PER_S", "NVLINK_BYTES_PER_S",
           "NETWORK_BYTES_PER_S", "ROUNDS", "Timer", "HostTimer", "make_timer",
           "alternate", "spread", "overhead", "bound_ms", "device_info",
           "pct", "markdown"]
