"""Selective SSM (Mamba-style) branch, used by Hymba's hybrid heads — the
JAX package's ``layers/mamba.py``.

    h_t = exp(Δ_t ∘ A) ∘ h_{t-1} + (Δ_t ∘ B_t) x_t
    y_t = C_t · h_t + D ∘ x_t

h ∈ R^{d_inner × N} (N = ssm_state).  The recurrence is elementwise, not
a GEMM, so ABFT does not apply to the scan itself; the in and out
projections and ``x_proj`` are ABFT-protected linears (K3 and K1 on the
card), and ``dt_proj`` is a float product.

The scan runs in plain PyTorch, one token a step, with JAX's operations
in JAX's order; the factors that do not depend on h (``exp(Δ A)`` and
``Δ B x``) are made for a run of tokens at once, elementwise, so each
step is a multiply and an add (:mod:`repro_torch.layers.scan`), and the
``C · h`` products follow as one batched product.  The JAX package has
no Pallas kernel here.  ``ctx.ssm_chunk > 0`` (when it divides the
length) runs JAX's two-level scan: chunk after chunk, each under
``torch.utils.checkpoint``, so the backward keeps h at the chunk bounds
and recomputes one chunk's steps at a time (the same steps, the same
numbers; the scan holds no protected call, so no counter moves twice).

The depthwise causal conv (kernel 4) is written with shifts; its state
(the last 3 inputs) joins the decode cache with the SSM state h.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core import policy
from repro_torch.layers.common import Ctx
from repro_torch.layers.linear import apply_linear, maybe_qlinear_init
from repro_torch.layers.scan import linear_scan

CONV_K = 4


def init_mamba(gen: torch.Generator, d: int, d_inner: int, n_state: int, *,
               dt_rank: int = 32, quant: bool = False, dtype=torch.float32,
               device):
    """The JAX ``init_mamba``'s tree and distributions (not its values:
    the generators differ): ``conv_w`` ~ N(0, 1) * 0.5, ``a_log`` and
    ``d_skip`` ones, ``dt_proj`` as :func:`init_dt`."""
    def normal(shape, scale):
        w = torch.randn(shape, generator=gen, device=device,
                        dtype=torch.float32)
        return (w * scale).to(dtype)

    return {
        "in_proj": maybe_qlinear_init(gen, d, 2 * d_inner, quant, dtype,
                                      bias=False, device=device),
        "conv_w": normal((CONV_K, d_inner), 0.5),
        "x_proj": maybe_qlinear_init(gen, d_inner, dt_rank + 2 * n_state,
                                     quant, dtype, bias=False,
                                     device=device),
        "dt_proj": init_dt(gen, dt_rank, d_inner, dtype, device=device),
        "a_log": torch.ones((d_inner, n_state), dtype=dtype, device=device),
        "d_skip": torch.ones((d_inner,), dtype=dtype, device=device),
        "out_proj": maybe_qlinear_init(gen, d_inner, d, quant, dtype,
                                       bias=False, device=device),
    }


def init_dt(gen: torch.Generator, dt_rank: int, d_inner: int, dtype, *,
            device):
    w = torch.randn((dt_rank, d_inner), generator=gen, device=device,
                    dtype=torch.float32)
    return {"w": (w * 0.02).to(dtype),
            "b": torch.zeros((d_inner,), dtype=dtype, device=device)}


def _causal_conv(x: torch.Tensor, conv_w: torch.Tensor,
                 conv_state: torch.Tensor):
    """x [B,S,di]; conv_state [B, K-1, di] (the previous inputs).

    Returns (y [B,S,di], new_conv_state)."""
    xc = torch.cat([conv_state, x], dim=1)                 # [B, S+K-1, di]
    s = x.shape[1]
    y = sum(xc[:, i:i + s, :] * conv_w[i][None, None, :]
            for i in range(CONV_K))
    return y, xc[:, -(CONV_K - 1):, :]


def _scan(h, dt, xc, b_t, c_t, a, graphs=None):
    """The selective scan over a run of tokens from state h: -> (y
    [B,S,di], h).  What does not read h is made for the whole run at
    once (``exp(Δ A)``, ``Δ B x``; [B,S,di,N]); the token loop
    (:func:`repro_torch.layers.scan.linear_scan`) runs ``h_t = exp(Δ_t
    A) ∘ h_{t-1} + Δ_t B_t x_t`` alone, and ``y_t = C_t · h_t`` is one
    batched product after it (JAX's step's operations).  ``graphs``:
    the training step's cache of captured loops (``ctx.scan_graphs``)."""
    da = torch.exp(dt[..., None] * a[None, None])
    dbx = (dt * xc)[..., None] * b_t[:, :, None, :]
    hs = linear_scan(da, dbx, h, graphs)
    return torch.einsum("bsdn,bsn->bsd", hs, c_t), hs[:, -1]


def mamba(p, x: torch.Tensor, cache, ctx: Ctx, *, d_inner: int,
          n_state: int, dt_rank: int = 32):
    """x [B,S,d]; cache {"conv": [B,K-1,di], "h": [B,di,N]} (f32).

    Returns (y [B,S,d], new_cache, report)."""
    xz, r1 = apply_linear(p["in_proj"], x, ctx, name="ssm.in_proj")
    xin, z = torch.chunk(xz, 2, dim=-1)                     # [B,S,di]
    conv_w = p["conv_w"].to(torch.float32)
    xc, conv_state = _causal_conv(xin.to(torch.float32), conv_w,
                                  cache["conv"])
    xc = F.silu(xc)

    bcd, r2 = apply_linear(p["x_proj"], xc.to(ctx.compute_dtype), ctx,
                           name="ssm.x_proj")
    bcd = bcd.to(torch.float32)
    dt_in = bcd[..., :dt_rank]
    b_t = bcd[..., dt_rank:dt_rank + n_state]               # [B,S,N]
    c_t = bcd[..., dt_rank + n_state:]                      # [B,S,N]
    dt = F.softplus(dt_in @ p["dt_proj"]["w"].to(torch.float32)
                    + p["dt_proj"]["b"].to(torch.float32))  # [B,S,di]
    a = -torch.exp(p["a_log"].to(torch.float32))            # [di,N]

    s = x.shape[1]
    chunk = ctx.ssm_chunk
    if chunk and s > 1 and s % chunk == 0:
        ys = []
        h = cache["h"]
        for i in range(0, s, chunk):
            y_c, h = checkpoint(_scan, h, dt[:, i:i + chunk],
                                xc[:, i:i + chunk], b_t[:, i:i + chunk],
                                c_t[:, i:i + chunk], a, ctx.scan_graphs,
                                use_reentrant=False)
            ys.append(y_c)
        ys = torch.cat(ys, dim=1)
    else:
        ys, h = _scan(cache["h"], dt, xc, b_t, c_t, a, ctx.scan_graphs)
    y = ys + xc * p["d_skip"].to(torch.float32)[None, None, :]
    y = y.to(ctx.compute_dtype) * F.silu(
        z.to(torch.float32)).to(ctx.compute_dtype)
    y, r3 = apply_linear(p["out_proj"], y, ctx, name="ssm.out_proj")
    return y, {"conv": conv_state, "h": h}, policy.merge_reports(r1, r2, r3)


def init_mamba_cache(batch: int, d_inner: int, n_state: int, *, device):
    """The zero state: ``conv`` [B, K-1, di] and ``h`` [B, di, N], f32."""
    return {"conv": torch.zeros((batch, CONV_K - 1, d_inner),
                                dtype=torch.float32, device=device),
            "h": torch.zeros((batch, d_inner, n_state), dtype=torch.float32,
                             device=device)}
