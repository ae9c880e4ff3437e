"""LayerNorm (f32 statistics, cast back to the input dtype).

RMSNorm and the qk head norm of the JAX package belong to the LM slice
(ROADMAP A8)."""
from __future__ import annotations

import torch


def init_layernorm(d: int, *, device, dtype=torch.float32):
    return {"scale": torch.ones((d,), dtype=dtype, device=device),
            "bias": torch.zeros((d,), dtype=dtype, device=device)}


def layernorm(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    # the population variance, as jnp.var: torch.var's default is unbiased
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"].to(torch.float32) + p["bias"].to(torch.float32)
    return y.to(x.dtype)
