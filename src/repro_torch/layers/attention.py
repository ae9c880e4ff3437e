"""GQA attention: chunked online-softmax attention (prefill and the
training forward) and one-token decode over a KV cache — the JAX
package's ``layers/attention.py``.

Layouts, as in JAX:
  * prefill: q, k, v in **H-layout** ``[B, H, S, dh]`` with the KV heads
    repeated to H;
  * decode: the cache in **grouped KV layout** ``[B, Kv, S, dh]``, either
    a plain tensor in the compute dtype or, where the plan enables
    ``kv_cache`` on the int8 serving path, a
    :class:`~repro_torch.core.QuantKV` (int8 rows with their rowsum
    checksums, verified on every decode read); or the paged pools of
    :mod:`repro_torch.paging` (a :class:`~repro_torch.paging.PagedKV`
    pair, page-checksummed, verified on touch).

The attention arithmetic is plain PyTorch: the JAX package runs it as
XLA code outside any Pallas kernel.  Products take bf16 operands with
float32 sums, as its ``preferred_element_type=float32`` einsums do (a
product of two bf16 values is exact in float32, so the operands are
widened and multiplied by ``torch.matmul`` in float32).  Masking
supports causal, a sliding window and an always-visible global prefix.

Cross-attention (whisper's decoder): :func:`attention` takes its keys
and values from ``x_kv`` without RoPE, and :func:`attention_decode` with
``cross=True`` reads the static cache of the encoder memory's K and V.

The ``constrain`` calls sit at the JAX module's sites with its axes:
the H-layout q, k and v over ``heads_x``, the caches sequence-parallel
over ``kv_seq``.  On one device and on a data mesh they move nothing;
the dry run's meta ``DTensor`` s are redistributed by them.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core import policy
from repro_torch.core.abft_kvcache import QuantKV, set_rows
from repro_torch.layers.common import Ctx
from repro_torch.layers.linear import apply_linear, maybe_qlinear_init
from repro_torch.layers.norms import headnorm, init_headnorm
from repro_torch.layers.rope import apply_rope
from repro_torch.paging.cache import PagedKV
from repro_torch.protect.ops import KV_CACHE, KV_CACHE_PAGED
from repro_torch.protect.runtime import (kv_rule, paged_kv_rule,
                                         protected_call)
from repro_torch.sharding.logical import constrain

NEG_INF = -1e30

#: the axes of a grouped-layout cache [B, Kv, S, dh] and of its QuantKV
#: fields' per-row vectors [B, Kv, S]
_CACHE_AXES = ("batch", None, "kv_seq", None)
_ROW_AXES = ("batch", None, "kv_seq")


def _constrain_cache(kv, rules):
    """The sequence-parallel constraint of one cache leaf: a plain tensor,
    or a :class:`QuantKV` field by field (the payload has a trailing head
    dim; the affine parameters and rowsums do not)."""
    if isinstance(kv, QuantKV):
        return QuantKV(q=constrain(kv.q, _CACHE_AXES, rules),
                       alpha=constrain(kv.alpha, _ROW_AXES, rules),
                       beta=constrain(kv.beta, _ROW_AXES, rules),
                       rowsum=constrain(kv.rowsum, _ROW_AXES, rules))
    return constrain(kv, _CACHE_AXES, rules)


def init_attention(gen: torch.Generator, d_model: int, n_heads: int,
                   n_kv: int, head_dim: int, *, qk_norm: bool = False,
                   quant: bool = False, dtype=torch.float32,
                   bias: bool = False, device):
    p = {
        "wq": maybe_qlinear_init(gen, d_model, n_heads * head_dim, quant,
                                 dtype, bias, device=device),
        "wk": maybe_qlinear_init(gen, d_model, n_kv * head_dim, quant,
                                 dtype, bias, device=device),
        "wv": maybe_qlinear_init(gen, d_model, n_kv * head_dim, quant,
                                 dtype, bias, device=device),
        "wo": maybe_qlinear_init(gen, n_heads * head_dim, d_model, quant,
                                 dtype, bias, device=device),
    }
    if qk_norm:
        p["q_norm"] = init_headnorm(head_dim, dtype=dtype, device=device)
        p["k_norm"] = init_headnorm(head_dim, dtype=dtype, device=device)
    return p


def _split_heads(x: torch.Tensor, n: int, head_dim: int) -> torch.Tensor:
    b, s, _ = x.shape
    return x.reshape(b, s, n, head_dim)


def _project(p, x, ctx: Ctx, *, n_heads, n_kv, head_dim, positions,
             use_rope, rope_theta, x_kv=None, kv_positions=None):
    """Project + norm + rope: q [B,S,H,dh], k and v [B,S,Kv,dh] and the
    three reports.  ``x_kv`` (cross-attention) gives k and v, and then
    nothing is rotated."""
    src = x if x_kv is None else x_kv
    q, r1 = apply_linear(p["wq"], x, ctx, name="attn.wq")
    k, r2 = apply_linear(p["wk"], src, ctx, name="attn.wk")
    v, r3 = apply_linear(p["wv"], src, ctx, name="attn.wv")
    q = _split_heads(q, n_heads, head_dim)
    k = _split_heads(k, n_kv, head_dim)
    v = _split_heads(v, n_kv, head_dim)
    if "q_norm" in p:
        q = headnorm(p["q_norm"], q)
        k = headnorm(p["k_norm"], k)
    if use_rope and x_kv is None:
        q = apply_rope(q, positions, rope_theta)
        k = apply_rope(k, positions if kv_positions is None
                       else kv_positions, rope_theta)
    return q, k, v, (r1, r2, r3)


def _h_layout(q, k, v, n_heads: int, n_kv: int, rules=None):
    """Repeat the KV heads to H and move heads before the sequence; the
    three are constrained to ``("batch", "heads_x", None, None)`` (H
    shards over ``model`` where it divides)."""
    g = n_heads // n_kv
    if g > 1:
        k = torch.repeat_interleave(k, g, dim=2)
        v = torch.repeat_interleave(v, g, dim=2)
    axes = ("batch", "heads_x", None, None)
    return tuple(constrain(t.transpose(1, 2), axes, rules)
                 for t in (q, k, v))


def _qkv(p, x, ctx: Ctx, *, n_heads, n_kv, head_dim, positions, use_rope,
         rope_theta, x_kv=None, kv_positions=None):
    """Project + norm + rope + repeat-to-H.  Returns q, k, v in H-layout
    ``[B, H, S, dh]`` and the three reports."""
    q, k, v, reps = _project(p, x, ctx, n_heads=n_heads, n_kv=n_kv,
                             head_dim=head_dim, positions=positions,
                             use_rope=use_rope, rope_theta=rope_theta,
                             x_kv=x_kv, kv_positions=kv_positions)
    return (*_h_layout(q, k, v, n_heads, n_kv, ctx.rules), reps)


def _bf16_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` of bf16-rounded operands, summed in float32."""
    return torch.matmul(a.to(torch.bfloat16).to(torch.float32),
                        b.to(torch.bfloat16).to(torch.float32))


def _window_mask(mask, qp, kp, window, prefix_global: int):
    if window is None:
        return mask
    in_win = (qp - kp) < window
    if prefix_global > 0:
        in_win = in_win | (kp < prefix_global)
    return mask & in_win


def flash_attention(q, k, v, *, q_positions, kv_positions, causal: bool,
                    window=None, prefix_global: int = 0, chunk: int = 1024):
    """Online-softmax attention over KV chunks.

    q [B,H,Sq,dh]; k, v [B,H,Skv,dh]; q_positions [B,Sq]; kv_positions
    [B,Skv] (-1 marks padding).  Returns [B,H,Sq,dh] (f32)."""
    b, h, sq, dh = q.shape
    skv = k.shape[2]
    chunk = min(chunk, skv)
    n_chunks = -(-skv // chunk)
    pad = n_chunks * chunk - skv
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, pad))
        kv_positions = torch.nn.functional.pad(kv_positions, (0, pad),
                                               value=-1)
    scale = dh ** -0.5
    # q is rounded to bf16 once, as JAX's ``qf``: its gradient then sums
    # the chunks' contributions in bf16, as JAX's scan does
    qf = q.to(torch.bfloat16)
    qp = q_positions[:, None, :, None]                     # [B,1,Sq,1]
    m = q.new_full((b, h, sq), NEG_INF, dtype=torch.float32)
    l = q.new_zeros((b, h, sq), dtype=torch.float32)
    acc = q.new_zeros((b, h, sq, dh), dtype=torch.float32)
    for c in range(n_chunks):
        sl = slice(c * chunk, (c + 1) * chunk)
        s = _bf16_matmul(qf, k[:, :, sl].transpose(-1, -2)) * scale
        kp = kv_positions[:, sl][:, None, None, :]          # [B,1,1,C]
        mask = kp >= 0
        if causal:
            mask = mask & (qp >= kp)
        mask = _window_mask(mask, qp, kp, window, prefix_global)
        s = torch.where(mask, s, torch.full_like(s, NEG_INF))
        m_new = torch.maximum(m, torch.amax(s, dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + torch.sum(p, dim=-1)
        acc = acc * corr[..., None] + _bf16_matmul(p, v[:, :, sl])
        m = m_new
    return acc / torch.clamp(l, min=1e-37)[..., None]


def attention(p, x, ctx: Ctx, *, n_heads: int, n_kv: int, head_dim: int,
              positions, rope_theta: float = 10000.0, use_rope: bool = True,
              causal: bool = True, window=None, prefix_global: int = 0,
              x_kv=None, kv_positions=None,
              chunk: int = 1024) -> Tuple[torch.Tensor, policy.FaultReport]:
    """Full-sequence attention (the training forward, whisper's encoder).
    x [B,S,d] -> [B,S,d].  ``x_kv`` [B,T,d] switches to cross-attention:
    keys and values from it (at ``kv_positions`` [B,T]), no RoPE."""
    b, s, _ = x.shape
    kv_pos = positions if kv_positions is None else kv_positions
    q, k, v, reps = _qkv(p, x, ctx, n_heads=n_heads, n_kv=n_kv,
                         head_dim=head_dim, positions=positions,
                         use_rope=use_rope, rope_theta=rope_theta,
                         x_kv=x_kv, kv_positions=kv_pos)
    out = flash_attention(q, k, v, q_positions=positions,
                          kv_positions=kv_pos, causal=causal,
                          window=window, prefix_global=prefix_global,
                          chunk=chunk)
    out = out.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    y, r4 = apply_linear(p["wo"], out.to(ctx.compute_dtype), ctx,
                         name="attn.wo")
    return y, policy.merge_reports(*reps, r4)


def attention_prefill(p, x, ctx: Ctx, *, n_heads, n_kv, head_dim,
                      positions, cache_len: int, rope_theta=10000.0,
                      use_rope=True, window=None, prefix_global: int = 0,
                      chunk: int = 1024):
    """Prefill: :func:`attention` plus the populated grouped-layout KV
    cache, padded with zero rows to ``cache_len``.  Returns (y, cache,
    report); the cache is ``{"k", "v"}`` in the compute dtype, or two
    :class:`QuantKV` where :func:`kv_rule` enables ``kv_cache`` (the
    zero pad rows then quantize to code -128, rowsum -128 * dh)."""
    b, s, _ = x.shape
    q, kh, vh, reps = _project(p, x, ctx, n_heads=n_heads, n_kv=n_kv,
                               head_dim=head_dim, positions=positions,
                               use_rope=use_rope, rope_theta=rope_theta)
    qh, k_full, v_full = _h_layout(q, kh, vh, n_heads, n_kv, ctx.rules)
    out = flash_attention(qh, k_full, v_full, q_positions=positions,
                          kv_positions=positions, causal=True, window=window,
                          prefix_global=prefix_global, chunk=chunk)
    out = out.transpose(1, 2).reshape(b, s, n_heads * head_dim)
    y, r4 = apply_linear(p["wo"], out.to(ctx.compute_dtype), ctx,
                         name="attn.wo")
    pad = (0, 0, 0, cache_len - s)           # along S of [B,Kv,S,dh]
    kt = kh.transpose(1, 2)                  # grouped layout [B,Kv,S,dh]
    vt = vh.transpose(1, 2)
    if kv_rule(ctx).enabled:
        # plan-selected quantized + checksummed cache (op kind kv_cache):
        # decode verifies every read (core.abft_kvcache)
        cache = {"k": KV_CACHE.encode(torch.nn.functional.pad(
                     kt.to(torch.float32), pad)),
                 "v": KV_CACHE.encode(torch.nn.functional.pad(
                     vt.to(torch.float32), pad))}
    else:
        cache = {"k": torch.nn.functional.pad(kt, pad),
                 "v": torch.nn.functional.pad(vt, pad)}
    cache = {n: _constrain_cache(c, ctx.rules) for n, c in cache.items()}
    return y, cache, policy.merge_reports(*reps, r4)


def attention_decode(p, x, cache, pos, ctx: Ctx, *, n_heads: int, n_kv: int,
                     head_dim: int, rope_theta: float = 10000.0,
                     use_rope: bool = True, window=None,
                     prefix_global: int = 0, cross: bool = False):
    """One-token decode.  x [B,d]; cache {k, v [B,Kv,S,dh]} — tensors in
    the compute dtype, or :class:`QuantKV` when the plan enables
    kv_cache protection — or {k, v: PagedKV} (per-layer pools); pos [B].
    The new row is written at ``pos``: into a new cache (a position past
    it is dropped, as in JAX), or into the mapped pool page in place.
    ``cross=True`` (whisper's decoder) projects q alone and attends the
    static cache of the encoder memory, every position valid; that cache
    is never quantized or paged.  Returns (y [B,d], new_cache, report)."""
    b, _ = x.shape
    if not isinstance(cache["k"], (torch.Tensor, QuantKV, PagedKV)):
        raise NotImplementedError(
            f"a {type(cache['k']).__name__} KV cache is not a tensor, "
            f"QuantKV or PagedKV")
    if cross:
        q, r1 = apply_linear(p["wq"], x[:, None, :], ctx, name="attn.wq")
        q = _split_heads(q, n_heads, head_dim)
        if "q_norm" in p:
            q = headnorm(p["q_norm"], q)
        return _attend_cache(p, q, cache, None, ctx, (r1,),
                             n_heads=n_heads, n_kv=n_kv, head_dim=head_dim)
    quant_kv = isinstance(cache["k"], QuantKV)
    paged_kv = isinstance(cache["k"], PagedKV)
    q, k_new, v_new, reports = _project(
        p, x[:, None, :], ctx, n_heads=n_heads, n_kv=n_kv,
        head_dim=head_dim, positions=pos[:, None], use_rope=use_rope,
        rope_theta=rope_theta)
    bidx = torch.arange(b, device=x.device)
    if paged_kv or quant_kv:
        if paged_kv:
            # scatter into the mapped page (page checksum maintained
            # incrementally); an unmapped slot's write is masked out.
            # The verify-on-touch read counts under a log rule: the
            # engine applies the plan's policy to the pages host-side.
            cache = {"k": KV_CACHE_PAGED.append(cache["k"], pos,
                                                k_new[:, 0]),
                     "v": KV_CACHE_PAGED.append(cache["v"], pos,
                                                v_new[:, 0])}
            op, rule = "kv_cache_paged", paged_kv_rule(ctx)
        else:
            # append: quantize + checksum the new rows (Alg. 2 style);
            # the read's policy (log/recompute/abort) is the plan rule's
            cache = {"k": KV_CACHE.update(cache["k"], bidx, pos,
                                          k_new[:, 0]),
                     "v": KV_CACHE.update(cache["v"], bidx, pos,
                                          v_new[:, 0])}
            cache = {n: _constrain_cache(c, ctx.rules)
                     for n, c in cache.items()}
            op, rule = "kv_cache", None
        # verified read + affine-expanded attention off the int8 cache
        out, r_kv = protected_call(
            op, (cache["k"], cache["v"]), q[:, 0], pos, ctx=ctx, rule=rule,
            name="attn", n_heads=n_heads, n_kv=n_kv, window=window,
            prefix_global=prefix_global)
        out = out.reshape(b, n_heads * head_dim).to(ctx.compute_dtype)
        y, r4 = apply_linear(p["wo"], out, ctx, name="attn.wo")
        return y, cache, policy.merge_reports(*reports, r_kv, r4)

    cache = {"k": set_rows(cache["k"], bidx, pos, k_new[:, 0]),
             "v": set_rows(cache["v"], bidx, pos, v_new[:, 0])}
    cache = {n: _constrain_cache(c, ctx.rules) for n, c in cache.items()}
    return _attend_cache(p, q, cache, pos, ctx, reports, n_heads=n_heads,
                         n_kv=n_kv, head_dim=head_dim, window=window,
                         prefix_global=prefix_global)


def _attend_cache(p, q, cache, pos, ctx: Ctx, reports, *, n_heads, n_kv,
                  head_dim, window=None, prefix_global: int = 0):
    """q [B,1,H,dh] against a plain grouped-layout cache, then ``wo``:
    positions up to ``pos`` (and in the window), or every position where
    ``pos`` is None (the cross cache).  Returns (y, cache, report)."""
    b = q.shape[0]
    s_max = cache["k"].shape[2]
    g = n_heads // n_kv
    qg = q.reshape(b, n_kv, g, head_dim)
    s = _bf16_matmul(qg, cache["k"].transpose(-1, -2)) * head_dim ** -0.5
    if pos is not None:
        kp = torch.arange(s_max, device=q.device)[None, None, None, :]
        qp = pos[:, None, None, None]
        valid = _window_mask(kp <= qp, qp, kp, window, prefix_global)
        s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    probs = torch.softmax(s, dim=-1)
    out = _bf16_matmul(probs, cache["v"])
    out = out.reshape(b, n_heads * head_dim).to(ctx.compute_dtype)
    y, r4 = apply_linear(p["wo"], out, ctx, name="attn.wo")
    return y, cache, policy.merge_reports(*reports, r4)
