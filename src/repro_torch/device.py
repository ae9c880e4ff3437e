"""Where the port runs: the card unless the caller asks for the CPU."""
from __future__ import annotations

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
