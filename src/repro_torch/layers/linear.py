"""Linear layers: float (bf16/f32) and int8+ABFT (the paper's serving
path).

The quantized linear runs Fig. 1 end to end:
  dynamic per-row activation quant (signed int8)  ->  int8 GEMM against the
  packed, checksum-encoded weight  ->  Eq. (3b) verify on the int32 C_temp
  (BEFORE requantization, §IV-B)  ->  rank-1 dequant + bias -> compute dtype.

Weights are packed once at init/conversion (amortized encoding, §IV-A1);
:func:`quantize_linear` converts a trained float linear into that form.
All verification goes through :func:`repro_torch.protect.protected_call`.
The float linear runs float-GEMM ABFT (beyond the paper) where the plan
enables ``float_gemm`` at its call site.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core import policy
from repro_torch.kernels import ops as kops
from repro_torch.layers.common import Ctx
from repro_torch.protect import ops as pops
from repro_torch.protect.runtime import protected_call, rule_for


# ----------------------------- float linear --------------------------------

def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype=torch.float32, bias: bool = True,
                scale: Optional[float] = None, *, device):
    """W ~ N(0, 1) * scale (default ``d_in ** -0.5``) in ``dtype`` and a
    zero bias — the JAX ``init_linear``'s distributions (not its values:
    the generators differ)."""
    scale = (d_in ** -0.5) if scale is None else scale
    w = torch.randn((d_in, d_out), generator=gen, device=device,
                    dtype=torch.float32)
    p = {"w": (w * scale).to(dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=device)
    return p


def encode_linear(p):
    """``p`` with its weight's f32 row sums (``checksum``), encoded once
    like the packed int8 weight's: the ``float_gemm`` check then also sees
    a fault in W itself, not only one in the product.  A float linear
    without them (the JAX package's) has its row sums taken from W at
    each call."""
    return {**p, "checksum": pops.FLOAT_GEMM.encode(p["w"])[1]}


def linear(p, x: torch.Tensor, ctx: Ctx, name: str = ""):
    """Float linear: x [..., d_in] -> (y [..., d_out] compute dtype,
    report), with float-GEMM ABFT on the 2-D product where the plan
    enables ``float_gemm`` at ``name`` (the JAX ``linear``'s rule)."""
    w = p["w"].to(ctx.compute_dtype)
    rule = rule_for(ctx, "float_gemm", name)
    if rule.enabled:
        m_shape = x.shape[:-1]
        x2 = x.reshape(-1, x.shape[-1])
        c, report = protected_call("float_gemm", (w, p.get("checksum")),
                                   x2, ctx=ctx, rule=rule, name=name)
        y = c.to(ctx.compute_dtype).reshape(*m_shape, w.shape[-1])
    else:
        y = x.to(ctx.compute_dtype) @ w
        report = policy.empty_report()
    if "b" in p:
        y = y + p["b"].to(ctx.compute_dtype)
    return y, report


# --------------------------- int8 ABFT linear ------------------------------


def init_qlinear(gen: torch.Generator, d_in: int, d_out: int,
                 bias: bool = True, *, device):
    """Random-int8 quantized weight in [-127, 127], packed with a
    consistent checksum, and alpha ~ U(1e-3, 2e-3) — the JAX package's
    distributions (not its values: the generators differ)."""
    w_q = torch.randint(-127, 128, (d_in, d_out), dtype=torch.int8,
                        generator=gen, device=device)
    alpha = torch.empty((d_out,), dtype=torch.float32, device=device)
    alpha.uniform_(1e-3, 2e-3, generator=gen)
    p = {
        "w_packed": pops.QGEMM.encode(w_q),            # [d_in, d_out+128]
        "alpha": alpha,
        "colsum": pops.QGEMM.dequant_colsum(w_q),
    }
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=torch.float32, device=device)
    return p


@torch.no_grad()
def quantize_linear(p_f32):
    """Convert a trained float linear into the packed ABFT form: symmetric
    per-output-channel int8 (``quant.quantize_channels``), packed with its
    checksum, and its bias kept in float32."""
    from repro_torch.quant import quantize_channels
    q = quantize_channels(p_f32["w"].to(torch.float32))
    out = {
        "w_packed": pops.QGEMM.encode(q.values),
        "alpha": q.alpha,
        "colsum": pops.QGEMM.dequant_colsum(q.values),
    }
    if "b" in p_f32:
        out["b"] = p_f32["b"].to(torch.float32)
    return out


def qlinear(p, x: torch.Tensor, ctx: Ctx, name: str = ""):
    """int8 ABFT linear: x [..., d_in] -> (y [..., d_out], report)."""
    packed = p["w_packed"]
    d_in = packed.shape[0]
    d_out = packed.shape[1] - pops.QGEMM.lane
    m_shape = x.shape[:-1]
    x2 = x.reshape(-1, d_in)

    # dynamic per-row signed-int8 quantization (kernel K3)
    x_q, a_alpha, a_beta = kops.quantize_rows(x2)

    # the plan decides scheme + policy + on/off for this call site; a
    # correct-policy site also hands over the exact int32 column sums so
    # single weight flips are repairable, not just detectable
    rule = rule_for(ctx, "qgemm", name)
    encoded = packed
    if rule.enabled and rule.policy == "correct" and "colsum" in p:
        encoded = (packed, torch.round(p["colsum"]).to(torch.int32))
    c, report = protected_call("qgemm", encoded, x_q, ctx=ctx, rule=rule,
                               name=name)

    # Requantization rank-1 algebra (Eq. 1 with symmetric B: beta_B = 0):
    #   y = alpha_A[i] * alpha_B[j] * C[i,j] + beta_A[i] * alpha_B[j] * colsum_B[j]
    w_alpha = p["alpha"]
    y = (a_alpha[:, None] * (c.to(torch.float32) * w_alpha[None, :])
         + a_beta[:, None] * (w_alpha * p["colsum"])[None, :])
    if "b" in p:
        y = y + p["b"][None, :]
    y = y.to(ctx.compute_dtype).reshape(*m_shape, d_out)
    return y, report


def maybe_qlinear_init(gen: torch.Generator, d_in: int, d_out: int,
                       quant: bool, dtype=torch.float32, bias: bool = True,
                       *, device):
    if quant:
        return init_qlinear(gen, d_in, d_out, bias=bias, device=device)
    return init_linear(gen, d_in, d_out, dtype=dtype, bias=bias,
                       device=device)


def apply_linear(p, x, ctx: Ctx, name: str = ""):
    """Dispatch on parameter form (packed int8 vs float)."""
    if "w_packed" in p:
        return qlinear(p, x, ctx, name)
    return linear(p, x, ctx, name)
