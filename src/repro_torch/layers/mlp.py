"""Feed-forward blocks: SwiGLU (llama family) and GeLU (whisper) — the JAX
package's ``layers/mlp.py``.  ``jax.nn.gelu`` is the tanh approximation by
default, and so is this one."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import policy
from repro_torch.layers.common import Ctx
from repro_torch.layers.linear import apply_linear, maybe_qlinear_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, *,
             gated: bool = True, quant: bool = False, dtype=torch.float32,
             bias: bool = False, device):
    p = {
        "up": maybe_qlinear_init(gen, d_model, d_ff, quant, dtype, bias,
                                 device=device),
        "down": maybe_qlinear_init(gen, d_ff, d_model, quant, dtype, bias,
                                   device=device),
    }
    if gated:
        p["gate"] = maybe_qlinear_init(gen, d_model, d_ff, quant, dtype,
                                       bias, device=device)
    return p


def mlp(p, x: torch.Tensor, ctx: Ctx):
    up, r1 = apply_linear(p["up"], x, ctx, name="mlp.up")
    if "gate" in p:
        gate, r2 = apply_linear(p["gate"], x, ctx, name="mlp.gate")
        h = F.silu(gate.to(torch.float32)).to(ctx.compute_dtype) * up
    else:
        r2 = policy.empty_report()
        h = F.gelu(up.to(torch.float32),
                   approximate="tanh").to(ctx.compute_dtype)
    y, r3 = apply_linear(p["down"], h, ctx, name="mlp.down")
    return y, policy.merge_reports(r1, r2, r3)
