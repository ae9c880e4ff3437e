"""Rotary position embeddings (f32 angles), the JAX package's
``layers/rope.py``.  Its ``sinusoid_positions`` (whisper's encoder table)
waits for the whisper slice (ROADMAP A7)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta: float = 10000.0, *,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10000.0) -> torch.Tensor:
    """x [B, S, H, dh] rotated by positions [B, S] (or [S]); the rotation
    runs in float32 and the result takes x's dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)         # [dh/2]
    ang = positions[..., None].to(torch.float32) * freqs    # [B, S, dh/2]
    cos = torch.cos(ang)[..., None, :]                      # [B, S, 1, dh/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    return torch.cat([y1, y2], dim=-1).to(x.dtype)
