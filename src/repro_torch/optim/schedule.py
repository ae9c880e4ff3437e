"""Learning-rate schedules of a 0-d int32 step tensor (the JAX
package's ``optim/schedule.py``): a float32 0-d tensor on the step's
device, divisions by tensors (the IEEE quotient on the card too)."""
from __future__ import annotations

import math

import torch


def warmup_cosine(step: torch.Tensor, *, peak: float, warmup: int,
                  total: int, floor: float = 0.0) -> torch.Tensor:
    s = step.to(torch.float32)

    def f32(v):
        return torch.tensor(float(v), dtype=torch.float32, device=s.device)

    warm = peak * s / f32(max(warmup, 1))
    prog = torch.clamp((s - warmup) / f32(max(total - warmup, 1)),
                       0.0, 1.0)
    cos = floor + 0.5 * (peak - floor) * (1.0 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, cos)


def constant_lr(step: torch.Tensor, *, peak: float, **_) -> torch.Tensor:
    return torch.full_like(step, peak, dtype=torch.float32)
