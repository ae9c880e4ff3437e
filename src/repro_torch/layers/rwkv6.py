"""RWKV6 "Finch" blocks: time-mix with data-dependent decay + channel-mix.

Per head (dh-dim), per timestep t::

    wkv_t = S_{t-1} + (u ∘ k_t) ⊗ v_t          (bonus for current token)
    y_t   = r_t · wkv_t
    S_t   = diag(w_t) · S_{t-1} + k_t ⊗ v_t     (data-dependent decay w_t)

with w_t = exp(-exp(w0 + lora(x_t))) ∈ (0, 1) per channel.  The
recurrence is an outer-product state update, not a GEMM, so the paper's
ABFT does not apply to it; the R/K/V/G/O projections and the channel-mix
are int8 ABFT linears like any other (kernels K3 and K1 on the card).

The layers come in two forms, as in the JAX package: int8 projections
(``quant``, the serving form) and float ones (``w``, the training form).
The int8 prefill runs the recurrence in its chunked matmul form over the
whole chunks of ``ctx.wkv_chunk`` (kernel K4 on the card) and the
per-token recurrence over the tail, carrying the state.  The float form
chooses as JAX does: the chunked form (K4's plain version,
:func:`repro_torch.kernels.ref.wkv_chunked_ref`, differentiable) when the length divides by the chunk, else the
per-token recurrence over every token.  K4 has no backward (nor has the
JAX package's Pallas kernel), so training never reaches it.  Decode
(S = 1) runs the per-token recurrence.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import policy
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.layers.common import Ctx
from repro_torch.layers.linear import apply_linear, maybe_qlinear_init
from repro_torch.layers.norms import init_layernorm, layernorm
from repro_torch.layers.scan import linear_scan


def _normal(gen: torch.Generator, shape, scale: float, device):
    """The JAX package's ``param()``: standard normal times ``scale``."""
    return torch.randn(shape, generator=gen, dtype=torch.float32,
                       device=device) * scale


def init_timemix(gen: torch.Generator, d: int, n_heads: int, *, device,
                 lora_rank: int = 64, quant: bool = False,
                 dtype=torch.float32):
    """The JAX ``init_timemix``'s tree and distributions (not its values:
    the generators differ): the projections int8 (``quant``) or float
    ``{w}`` without bias, the other leaves in ``dtype``."""
    dh = d // n_heads

    def q(d_in, d_out):
        return maybe_qlinear_init(gen, d_in, d_out, quant, dtype,
                                  bias=False, device=device)

    def normal(shape, scale):
        return _normal(gen, shape, scale, device).to(dtype)

    return {
        "mu": normal((5, d), 0.5),
        "w0": normal((d,), 0.5),
        "w_lora_a": normal((d, lora_rank), 0.02),
        "w_lora_b": normal((lora_rank, d), 0.02),
        "bonus": normal((n_heads, dh), 0.5),
        "wr": q(d, d), "wk": q(d, d), "wv": q(d, d), "wg": q(d, d),
        "wo": q(d, d),
        "ln_x": init_layernorm(d, device=device, dtype=dtype),
    }


def _token_shift(x: torch.Tensor, x_prev: torch.Tensor) -> torch.Tensor:
    """[B,S,d] shifted right by one; position 0 sees x_prev (decode carry)."""
    return torch.cat([x_prev[:, None, :], x[:, :-1, :]], dim=1)


#: log-decay clamp: w = exp(lw), lw ∈ [LOG_W_MIN, 0].  Decays below
#: e^-5 ≈ 6.7e-3 wipe the state within one step anyway; the clamp bounds
#: the chunked form's intra-chunk exponents (C·|lw| ≤ 80 < log f32max ≈ 88
#: for C=16) — the same clamp the official RWKV CUDA kernels apply.
LOG_W_MIN = -5.0


def wkv_recurrent(rh, kh, vh, lwh, u, state, graphs=None):
    """Per-token reference recurrence (the paper-faithful form; decode).

    rh/kh/vh/lwh [B,S,H,dh] f32 (lwh = log decay), u [H,dh],
    state [B,H,dh,dh].  Returns (ys [B,S,H,dh], new_state).

    JAX's scan step, with only what reads the state left in the token
    loop (:func:`repro_torch.layers.scan.linear_scan`): ``kv = k ⊗ v``
    and ``u ∘ kv`` are made for every token at once, the loop runs
    ``S_t = w_t ∘ S_{t-1} + kv_t``, and every token's ``y_t = r_t ·
    (S_{t-1} + u ∘ kv_t)`` is one batched product after it.  Each value
    is computed by the operation JAX's step computes it with.
    ``graphs``: the training step's cache of captured loops
    (``ctx.scan_graphs``)."""
    kv = kh[..., :, None] * vh[..., None, :]                # [B,S,H,dh,dh]
    states = linear_scan(torch.exp(lwh)[..., :, None], kv, state, graphs)
    prev = torch.cat([state[:, None], states[:, :-1]], dim=1)
    wkv = prev + u[None, None, :, :, None] * kv
    ys = (rh[..., None, :] @ wkv).squeeze(-2)               # [B,S,H,dh]
    return ys, states[:, -1]


def _check_chunk(chunk: int) -> None:
    if chunk * abs(LOG_W_MIN) > 80.0:
        raise ValueError(
            f"chunk={chunk} exceeds the f32-safe envelope for "
            f"LOG_W_MIN={LOG_W_MIN}; use chunk <= {int(80 / abs(LOG_W_MIN))}")


def wkv_chunked(rh, kh, vh, lwh, u, state, *, chunk: int = 16):
    """Matmul-form chunked WKV6: an exact reformulation of
    :func:`wkv_recurrent` (same clamp), through
    :func:`repro_torch.kernels.ops.wkv_chunked` — kernel K4 on the card,
    :func:`repro_torch.kernels.ref.wkv_chunked_ref` on the CPU.

    The intra-chunk factor e^{-la_j} reaches e^{chunk·|LOG_W_MIN|}, so the
    chunk must keep that clear of the f32 maximum (e^88.7)."""
    _check_chunk(chunk)
    return kops.wkv_chunked(rh, kh, vh, lwh, u, state, chunk=chunk)


def timemix(p, x, x_prev, state, ctx: Ctx, *, n_heads: int
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                       policy.FaultReport]:
    """x [B,S,d], x_prev [B,d], state S [B,H,dh,dh] (f32).

    Int8 projections (the serving form): ``ctx.wkv_chunk > 0`` runs the
    chunked form (K4) over the first ``(S // chunk) * chunk`` tokens
    (S > 1) and the per-token recurrence over the rest, carrying the
    state.  Float projections: as JAX, the chunked form
    (:func:`repro_torch.kernels.ref.wkv_chunked_ref`, plain PyTorch,
    bf16 operands where ``ctx.wkv_mm_bf16``)
    when ``S % chunk == 0``, else the recurrence over every token.
    Returns (y, new_x_prev, new_state, report)."""
    b, s, d = x.shape
    dh = d // n_heads
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(torch.float32)
    xf, xsf = x.to(torch.float32), xs.to(torch.float32)

    def mix(i):
        return (xf + (xsf - xf) * mu[i]).to(ctx.compute_dtype)

    xr, xk, xv, xw, xg = (mix(i) for i in range(5))
    r, r1 = apply_linear(p["wr"], xr, ctx, name="tm.wr")
    k, r2 = apply_linear(p["wk"], xk, ctx, name="tm.wk")
    v, r3 = apply_linear(p["wv"], xv, ctx, name="tm.wv")
    g, r4 = apply_linear(p["wg"], xg, ctx, name="tm.wg")
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(xw))), log-clamped
    lora = torch.tanh(xw.to(torch.float32) @ p["w_lora_a"].to(torch.float32)
                      ) @ p["w_lora_b"].to(torch.float32)
    lw = torch.clamp(-torch.exp(p["w0"].to(torch.float32) + lora),
                     LOG_W_MIN, 0.0)                             # [B,S,d]

    rh, kh, vh = (t.reshape(b, s, n_heads, dh) for t in (r, k, v))
    lwh = lw.reshape(b, s, n_heads, dh)
    u = p["bonus"].to(torch.float32)                             # [H,dh]

    chunk = ctx.wkv_chunk
    if "w_packed" not in p["wr"]:
        rh, kh, vh = (t.to(torch.float32) for t in (rh, kh, vh))
        if chunk and s > 1 and s % chunk == 0:
            _check_chunk(chunk)
            y, state = kref.wkv_chunked_ref(
                rh, kh, vh, lwh, u, state, chunk=chunk,
                mm_dtype=(torch.bfloat16 if ctx.wkv_mm_bf16
                          else torch.float32))
        else:
            y, state = wkv_recurrent(rh, kh, vh, lwh, u, state,
                                     ctx.scan_graphs)
        y = y.reshape(b, s, d)
    else:
        head = (s // chunk) * chunk if chunk and s > 1 else 0
        ys = []
        if head:
            # r, k, v in the compute dtype: K4 reads bf16 as it is and the
            # plain path casts to f32 (exact), as the JAX layer does
            y_head, state = wkv_chunked(rh[:, :head], kh[:, :head],
                                        vh[:, :head], lwh[:, :head], u,
                                        state, chunk=chunk)
            ys.append(y_head)
        if head < s:
            y_tail, state = wkv_recurrent(
                *(t[:, head:].to(torch.float32) for t in (rh, kh, vh)),
                lwh[:, head:], u, state)
            ys.append(y_tail)
        y = (ys[0] if len(ys) == 1 else torch.cat(ys, dim=1)).reshape(
            b, s, d)
    y = layernorm(p["ln_x"], y.to(ctx.compute_dtype))
    y = y * F.silu(g.to(torch.float32)).to(ctx.compute_dtype)
    y, r5 = apply_linear(p["wo"], y, ctx, name="tm.wo")
    return (y, x[:, -1, :], state,
            policy.merge_reports(r1, r2, r3, r4, r5))


def init_channelmix(gen: torch.Generator, d: int, d_ff: int, *, device,
                    quant: bool = False, dtype=torch.float32):
    return {
        "mu": _normal(gen, (2, d), 0.5, device).to(dtype),
        "wk": maybe_qlinear_init(gen, d, d_ff, quant, dtype, bias=False,
                                 device=device),
        "wv": maybe_qlinear_init(gen, d_ff, d, quant, dtype, bias=False,
                                 device=device),
    }


def channelmix(p, x, x_prev, ctx: Ctx):
    """Squared-ReLU channel mix. Returns (y, new_x_prev, report)."""
    xs = _token_shift(x, x_prev)
    mu = p["mu"].to(torch.float32)
    xf, xsf = x.to(torch.float32), xs.to(torch.float32)
    xk = (xf + (xsf - xf) * mu[0]).to(ctx.compute_dtype)
    k, r1 = apply_linear(p["wk"], xk, ctx, name="cm.wk")
    k = torch.square(torch.relu(k.to(torch.float32))).to(ctx.compute_dtype)
    y, r2 = apply_linear(p["wv"], k, ctx, name="cm.wv")
    return y, x[:, -1, :], policy.merge_reports(r1, r2)
