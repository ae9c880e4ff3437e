"""Rotary position embeddings (f32 angles) and whisper's sinusoid
encoder table, the JAX package's ``layers/rope.py``."""
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


def sinusoid_positions(seq_len: int, d: int, *, device=None) -> torch.Tensor:
    """Whisper-encoder style absolute sinusoid table [seq_len, d] (f32):
    sines then cosines of ``pos * 10000 ** (-i / (d/2 - 1))``.  The
    exponential may round differently from XLA's by an ulp, which moves
    an angle by up to ``pos`` ulps of 1: at whisper's 1500 frames the
    table parts from JAX's by up to ~1.2e-4."""
    half = d // 2
    pos = torch.arange(seq_len, dtype=torch.float32, device=device)[:, None]
    # JAX's order, (-log 1e4 * i) / (half - 1), and a tensor divisor: the
    # quotient JAX's is, not a multiple of the reciprocal
    log_t = torch.log(torch.tensor(10000.0, device=device))
    inv = torch.exp((-log_t * torch.arange(half, dtype=torch.float32,
                                           device=device))
                    / torch.tensor(float(max(half - 1, 1)), device=device))
    ang = pos * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
