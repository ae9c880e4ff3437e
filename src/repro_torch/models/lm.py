"""Decoder-only LM, the dense (Llama-3.2, Qwen3, InternLM2), MoE
(granite-moe), hybrid (hymba) and VLM (llava-next) families — the JAX
package's ``models/lm.py``.

The parameter and cache trees keep the JAX layout, so
:func:`repro_torch.models.convert.from_jax` carries its weights over
unchanged and :func:`repro_torch.core.inject.victim_leaf_index` picks the
same victim leaf: every per-layer leaf is stacked on a leading ``[L,
...]`` axis (the JAX model vmaps its layer init and scans over layers;
here the layer loop is written out and indexes the stack), and the cache
is ``{"attn": {"k", "v"}}`` with leaves ``[L, B, Kv, S, dh]`` (or
:class:`~repro_torch.core.QuantKV` of them), or, in the engine's paged
lanes, two :class:`~repro_torch.paging.PagedKV` pools with leading-L
leaves.  Every forward threads a FaultReport, and the full-sequence
forward sums the MoE layers' load-balance loss (0 for the others).  A
MoE layer has ``moe`` (:mod:`repro_torch.layers.moe`) where the others
have ``mlp``.

Hymba's layers run a Mamba branch (:mod:`repro_torch.layers.mamba`)
beside the attention on the same normed input and mix the two as
``0.5 * (rmsnorm(attn) + rmsnorm(ssm))``; its 128 learned meta tokens
open every sequence, always visible to the sliding-window layers, and
its cache adds the ``ssm`` state (``conv`` [L, B, 3, di] and ``h`` [L,
B, di, N], f32).  Llava's stub patch features pass the two-layer
projector (protected linears) and open the sequence before the text.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig
from repro_torch.core import policy
from repro_torch.device import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers import mamba as mam
from repro_torch.layers.common import (Ctx, init_stacked, layer_at,
                                       stack_layers, unstack_layers)
from repro_torch.layers.embedding import apply_embed, init_embed, init_qembed
from repro_torch.layers.linear import apply_linear, maybe_qlinear_init
from repro_torch.layers.mlp import init_mlp, mlp
from repro_torch.layers.moe import init_moe, moe_ffn
from repro_torch.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.paging.cache import PagedKV
from repro_torch.sharding.logical import constrain

HUGE_WINDOW = 1 << 30

#: the families this module runs
FAMILIES = ("dense", "moe", "hybrid", "vlm")


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise ValueError(f"family {cfg.family!r} is not a decoder LM; "
                         f"models.lm runs {FAMILIES}")


# ------------------------------- init ---------------------------------------

def init_layer(gen: torch.Generator, cfg: ArchConfig, quant: bool, dtype, *,
               device):
    _check_family(cfg)
    d = cfg.d_model
    p = {
        "ln1": init_rmsnorm(d, dtype=dtype, device=device),
        "ln2": init_rmsnorm(d, dtype=dtype, device=device),
        "attn": attn.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                    cfg.head_dim_, qk_norm=cfg.qk_norm,
                                    quant=quant, dtype=dtype, device=device),
    }
    if cfg.family == "moe":
        p["moe"] = init_moe(gen, d, cfg.d_ff, cfg.n_experts, quant=quant,
                            dtype=dtype, device=device)
    else:
        p["mlp"] = init_mlp(gen, d, cfg.d_ff, gated=cfg.gated_mlp,
                            quant=quant, dtype=dtype, device=device)
    if cfg.family == "hybrid":
        p["ssm"] = mam.init_mamba(gen, d, cfg.d_inner_, cfg.ssm_state,
                                  quant=quant, dtype=dtype, device=device)
        p["attn_out_norm"] = init_rmsnorm(d, dtype=dtype, device=device)
        p["ssm_out_norm"] = init_rmsnorm(d, dtype=dtype, device=device)
    return p


@torch.no_grad()
def init_lm(seed: int, cfg: ArchConfig, quant: bool = False,
            dtype=torch.float32, *, device="cuda"):
    """Random LM parameters from ``seed``, made on ``device``: the JAX
    ``init_lm`` distributions (not its values: the generators differ).
    ``quant`` gives the int8 serving form: the token table as
    :func:`init_qembed` and every linear as ``init_qlinear`` without
    bias, over the padded vocabulary.  ``device="meta"`` gives the
    tree's shapes and dtypes without storage."""
    _check_family(cfg)
    # "meta" gives the tree's shapes and dtypes without storage
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    vp = cfg.vocab_padded
    p = {
        "embed": (init_qembed(gen, vp, cfg.d_model, device=dev) if quant
                  else init_embed(gen, vp, cfg.d_model, dtype=dtype,
                                  device=dev)),
        "final_norm": init_rmsnorm(cfg.d_model, dtype=dtype, device=dev),
        "lm_head": maybe_qlinear_init(gen, cfg.d_model, vp, quant, dtype,
                                      bias=False, device=dev),
        "layers": init_stacked(lambda: init_layer(gen, cfg, quant, dtype,
                                                  device=dev),
                               cfg.n_layers),
    }
    if cfg.meta_tokens:
        w = torch.randn((cfg.meta_tokens, cfg.d_model), generator=gen,
                        device=dev, dtype=torch.float32)
        p["meta"] = (w * 0.02).to(dtype)
    if cfg.patch_dim:
        p["projector"] = {
            "fc1": maybe_qlinear_init(gen, cfg.patch_dim, cfg.d_model,
                                      quant, dtype, device=dev),
            "fc2": maybe_qlinear_init(gen, cfg.d_model, cfg.d_model, quant,
                                      dtype, device=dev)}
    return p


def window_schedule(cfg: ArchConfig) -> torch.Tensor:
    """Per-layer attention window ([L] int32 on the CPU; HUGE = full
    attention)."""
    return torch.tensor(
        [HUGE_WINDOW if cfg.sliding_window == 0 or cfg.is_global_layer(i)
         else cfg.sliding_window for i in range(cfg.n_layers)],
        dtype=torch.int32)


def _windows(cfg: ArchConfig) -> list:
    """The schedule as Python ints, None where a layer attends in full
    (the mask of a HUGE window is all true, so it is not built)."""
    return [None if w >= HUGE_WINDOW else w
            for w in window_schedule(cfg).tolist()]


def _ffn(layer_p, h: torch.Tensor, ctx: Ctx, cfg: ArchConfig):
    """The layer's feed-forward: (y, load-balance loss, report)."""
    if cfg.family == "moe":
        return moe_ffn(layer_p["moe"], h, ctx, n_experts=cfg.n_experts,
                       top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
                       group_size=cfg.moe_group)
    y, rep = mlp(layer_p["mlp"], h, ctx)
    return y, torch.zeros((), dtype=torch.float32, device=h.device), rep


def _prefix_embeds(params, x_text, ctx: Ctx, cfg: ArchConfig, patches,
                   reports: list):
    """Prepend projector(patches) (VLM) and the meta tokens (Hymba):
    [meta, patches, text]; the projector's reports join ``reports``."""
    b = x_text.shape[0]
    parts = []
    if cfg.patch_dim and patches is not None:
        h, r1 = apply_linear(params["projector"]["fc1"],
                             patches.to(ctx.compute_dtype), ctx,
                             name="projector.fc1")
        h = F.gelu(h.to(torch.float32),
                   approximate="tanh").to(ctx.compute_dtype)
        h, r2 = apply_linear(params["projector"]["fc2"], h, ctx,
                             name="projector.fc2")
        reports += [r1, r2]
        parts.append(h)
    if cfg.meta_tokens:
        meta = params["meta"].to(ctx.compute_dtype)[None].expand(
            b, cfg.meta_tokens, cfg.d_model)
        parts.insert(0, meta)
    parts.append(x_text)
    return torch.cat(parts, dim=1) if len(parts) > 1 else x_text


def _ssm_mix(layer_p, a_out, s_out):
    """Hymba's mix of the attention and SSM heads' outputs."""
    return 0.5 * (rmsnorm(layer_p["attn_out_norm"], a_out)
                  + rmsnorm(layer_p["ssm_out_norm"], s_out))


# ------------------------------ full-seq forward ----------------------------

def lm_hidden(params, tokens, ctx: Ctx, cfg: ArchConfig, *, patches=None,
              with_cache: bool = False, cache_len: int = 0):
    """Embed + all layers.  Returns (x [B,S',d], cache | None, report,
    aux); S' counts the meta tokens and patches before the text, and the
    cache is stacked ``[L, ...]`` as the JAX layer scan stacks it.
    Differentiable: the training loss takes its gradient through it
    (float parameters that require grad); the serving entry points call
    it under ``torch.no_grad``.  The stacked leaves are unbound into
    layers once (``unstack_layers``), so the layers' gradients are
    stacked in one op, as JAX's scan gives them.  Under autograd each
    layer is recomputed in the backward (``torch.utils.checkpoint``), as
    JAX remats its layer scan, unless ``ctx.no_remat``: remat changes
    memory, not numbers.  The hidden state is constrained to
    ``("batch", "seq", None)`` before and after every layer, at JAX's
    sites."""
    _check_family(cfg)
    x_text, rep0 = apply_embed(params["embed"], tokens, ctx)
    reports = [rep0]
    x = _prefix_embeds(params, x_text, ctx, cfg, patches, reports)
    rep = policy.merge_reports(*reports)
    b, s, _ = x.shape
    x = constrain(x, ("batch", "seq", None), ctx.rules)
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, positions=positions,
              rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
              prefix_global=cfg.meta_tokens, chunk=cfg.attn_chunk)

    def body(layer_p, window, x):
        h = rmsnorm(layer_p["ln1"], x)
        if with_cache:
            a_out, cache_l, r_a = attn.attention_prefill(
                layer_p["attn"], h, ctx, cache_len=cache_len, window=window,
                **kw)
            cache_l = {"attn": cache_l}
        else:
            a_out, r_a = attn.attention(layer_p["attn"], h, ctx, causal=True,
                                        window=window, **kw)
            cache_l = None
        if cfg.family == "hybrid":
            s_out, ssm_cache, r_s = mam.mamba(
                layer_p["ssm"], h, mam.init_mamba_cache(
                    b, cfg.d_inner_, cfg.ssm_state, device=x.device), ctx,
                d_inner=cfg.d_inner_, n_state=cfg.ssm_state)
            r_a = policy.merge_reports(r_a, r_s)
            x = x + _ssm_mix(layer_p, a_out, s_out)
            if with_cache:
                cache_l["ssm"] = ssm_cache
        else:
            x = x + a_out
        h2 = rmsnorm(layer_p["ln2"], x)
        f_out, aux_l, r_f = _ffn(layer_p, h2, ctx, cfg)
        x = x + f_out
        x = constrain(x, ("batch", "seq", None), ctx.rules)
        return x, aux_l, policy.merge_reports(r_a, r_f), cache_l

    remat = (not with_cache and not ctx.no_remat
             and torch.is_grad_enabled())
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = unstack_layers(params["layers"], cfg.n_layers)
    for layer_p, window in zip(layers, _windows(cfg)):
        if remat:
            x, aux_l, r_l, cache_l = checkpoint(body, layer_p, window, x,
                                                use_reentrant=False)
        else:
            x, aux_l, r_l, cache_l = body(layer_p, window, x)
        if with_cache:
            caches.append(cache_l)
        aux = aux + aux_l
        rep = policy.merge_reports(rep, r_l)
    x = rmsnorm(params["final_norm"], x)
    cache = stack_layers(caches) if with_cache else None
    return x, cache, rep, aux


def lm_logits(params, tokens, ctx: Ctx, cfg: ArchConfig, patches=None):
    """Training forward: full logits [B, S', vocab_padded] (differentiable,
    as :func:`lm_hidden`)."""
    x, _, rep, aux = lm_hidden(params, tokens, ctx, cfg, patches=patches)
    logits, r_h = apply_linear(params["lm_head"], x, ctx, name="lm_head")
    logits = constrain(logits, ("batch", "seq", "vocab"), ctx.rules)
    return logits, policy.merge_reports(rep, r_h), aux


@torch.no_grad()
def lm_prefill(params, tokens, ctx: Ctx, cfg: ArchConfig, *,
               cache_len: int, patches=None):
    """Prefill: last-position logits + the populated KV cache (and the
    hybrid's SSM state)."""
    x, cache, rep, _ = lm_hidden(params, tokens, ctx, cfg, patches=patches,
                                 with_cache=True, cache_len=cache_len)
    logits, r_h = apply_linear(params["lm_head"], x[:, -1, :], ctx,
                               name="lm_head")
    return logits, cache, policy.merge_reports(rep, r_h)


# ------------------------------ decode --------------------------------------

@torch.no_grad()
def lm_decode(params, cache, tokens, pos, ctx: Ctx, cfg: ArchConfig):
    """One decode step.  tokens [B] int32, pos [B] int32 (absolute).
    Returns (logits [B, vp], new_cache, report).  A paged cache is
    written in place through each layer's view of the stacked pools and
    comes back as it went in, with no copy; the other caches are stacked
    anew from the layers' new ones, as the JAX layer scan stacks them."""
    _check_family(cfg)
    x, rep = apply_embed(params["embed"], tokens, ctx)     # [B, d]
    new = []
    for i, window in enumerate(_windows(cfg)):
        layer_p = layer_at(params["layers"], i)
        h = rmsnorm(layer_p["ln1"], x)
        a_out, new_attn, r_a = attn.attention_decode(
            layer_p["attn"], h, layer_at(cache["attn"], i), pos, ctx,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            head_dim=cfg.head_dim_, rope_theta=cfg.rope_theta,
            use_rope=cfg.use_rope, window=window,
            prefix_global=cfg.meta_tokens)
        new_l = {"attn": new_attn}
        if cfg.family == "hybrid":
            s_out, new_l["ssm"], r_s = mam.mamba(
                layer_p["ssm"], h[:, None, :], layer_at(cache["ssm"], i),
                ctx, d_inner=cfg.d_inner_, n_state=cfg.ssm_state)
            r_a = policy.merge_reports(r_a, r_s)
            x = x + _ssm_mix(layer_p, a_out, s_out[:, 0, :])
        else:
            x = x + a_out
        new.append(new_l)
        h2 = rmsnorm(layer_p["ln2"], x)
        if cfg.family == "moe":
            f_out, _, r_f = _ffn(layer_p, h2[:, None, :], ctx, cfg)
            f_out = f_out[:, 0, :]
        else:
            f_out, r_f = mlp(layer_p["mlp"], h2, ctx)
        x = x + f_out
        rep = policy.merge_reports(rep, r_a, r_f)
    x = rmsnorm(params["final_norm"], x)
    logits, r_h = apply_linear(params["lm_head"], x, ctx, name="lm_head")
    if isinstance(cache["attn"]["k"], PagedKV):
        new_cache = cache
    else:
        new_cache = stack_layers(new)
    return logits, new_cache, policy.merge_reports(rep, r_h)


# ------------------------------ cache init ----------------------------------

def init_lm_cache(cfg: ArchConfig, batch: int, cache_len: int, *, device):
    """The zero bf16 cache, stacked ``[L, ...]`` (and the hybrid's zero
    f32 SSM state)."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads,
             cache_len + cfg.meta_tokens, cfg.head_dim_)
    cache = {"attn": {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device),
                      "v": torch.zeros(shape, dtype=torch.bfloat16,
                                       device=device)}}
    if cfg.family == "hybrid":
        cache["ssm"] = stack_layers([
            mam.init_mamba_cache(batch, cfg.d_inner_, cfg.ssm_state,
                                 device=device)
            for _ in range(cfg.n_layers)])
    return cache
