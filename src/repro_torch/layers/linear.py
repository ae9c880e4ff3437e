"""int8 + ABFT linear layer (the paper's serving path).

The quantized linear runs Fig. 1 end to end:
  dynamic per-row activation quant (signed int8)  ->  int8 GEMM against the
  packed, checksum-encoded weight  ->  Eq. (3b) verify on the int32 C_temp
  (BEFORE requantization, §IV-B)  ->  rank-1 dequant + bias -> compute dtype.

Weights are packed once at init/conversion (amortized encoding, §IV-A1).
All verification goes through :func:`repro_torch.protect.protected_call`.
The bf16 ``linear`` and ``quantize_linear`` of the JAX package belong to
the training slice (ROADMAP A10).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops as kops
from repro_torch.layers.common import Ctx
from repro_torch.protect import ops as pops
from repro_torch.protect.runtime import protected_call, rule_for


def init_qlinear(gen: torch.Generator, d_in: int, d_out: int,
                 bias: bool = True, device="cpu"):
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


def apply_linear(p, x, ctx: Ctx, name: str = ""):
    """Dispatch on parameter form; only the packed int8 form is ported."""
    if "w_packed" not in p:
        raise NotImplementedError("the float linear is not ported yet "
                                  "(ROADMAP A10)")
    return qlinear(p, x, ctx, name)
