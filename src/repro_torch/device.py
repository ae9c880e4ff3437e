"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

import contextlib
import os
from typing import Union

import torch


def resolve_device(device: Union[str, torch.device] = "cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; a CUDA device must exist.

    The port's entry points default to ``"cuda"`` and never fall back to
    the CPU: without a card they raise unless the caller passed
    ``device="cpu"`` (as the CPU tests do)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run the plain PyTorch path on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device!r} (cuda or cpu)")
    return dev


@contextlib.contextmanager
def deterministic():
    """Run the block under ``torch.use_deterministic_algorithms(True)``
    (restored after): the training paths compare parameters bit for bit
    (a clean twin, a recompute), and on the card the embedding backward's
    atomics and cuBLAS's split reductions are not deterministic by
    default.  cuBLAS also needs ``CUBLAS_WORKSPACE_CONFIG=:4096:8`` in the
    environment before CUDA initialises; an entry point that trains sets
    it first thing (it is set here too, for the check PyTorch makes at
    each cuBLAS call)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev)
