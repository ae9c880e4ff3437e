"""Decoder-only LM, the dense (Llama-3.2, Qwen3) and MoE
(granite-moe) families — the JAX package's ``models/lm.py``.

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
forward sums the MoE layers' load-balance loss (0 for dense).  A MoE
layer has ``moe`` (:mod:`repro_torch.layers.moe`) where a dense one has
``mlp``.

The JAX module's hybrid (hymba) and VLM (llava) families wait for
ROADMAP A7; they raise.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import policy
from repro_torch.device import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers.common import (Ctx, layer_at, stack_layers,
                                       unstack_layers)
from repro_torch.layers.embedding import apply_embed, init_embed, init_qembed
from repro_torch.layers.linear import apply_linear, maybe_qlinear_init
from repro_torch.layers.mlp import init_mlp, mlp
from repro_torch.layers.moe import init_moe, moe_ffn
from repro_torch.layers.norms import init_rmsnorm, rmsnorm
from repro_torch.paging.cache import PagedKV

HUGE_WINDOW = 1 << 30

#: the LM families the port does not serve yet, and their ROADMAP items
_NOT_PORTED = {"hybrid": "A7 (mamba / hymba)", "vlm": "A7 (llava)"}


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in ("dense", "moe"):
        item = _NOT_PORTED.get(cfg.family, "none: not a decoder LM")
        raise NotImplementedError(
            f"LM family {cfg.family!r} is not ported yet (ROADMAP {item}); "
            f"models.lm serves 'dense' and 'moe'")


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
    return {
        "embed": (init_qembed(gen, vp, cfg.d_model, device=dev) if quant
                  else init_embed(gen, vp, cfg.d_model, dtype=dtype,
                                  device=dev)),
        "final_norm": init_rmsnorm(cfg.d_model, dtype=dtype, device=dev),
        "lm_head": maybe_qlinear_init(gen, cfg.d_model, vp, quant, dtype,
                                      bias=False, device=dev),
        "layers": stack_layers([init_layer(gen, cfg, quant, dtype,
                                           device=dev)
                                for _ in range(cfg.n_layers)]),
    }


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


# ------------------------------ full-seq forward ----------------------------

def lm_hidden(params, tokens, ctx: Ctx, cfg: ArchConfig, *,
              with_cache: bool = False, cache_len: int = 0):
    """Embed + all layers.  Returns (x [B,S,d], cache | None, report,
    aux); the cache is stacked ``[L, ...]`` as the JAX layer scan
    stacks it.  Differentiable: the training loss takes its gradient
    through it (float parameters that require grad); the serving entry
    points call it under ``torch.no_grad``.  The stacked leaves are
    unbound into layers once (``unstack_layers``), so the layers'
    gradients are stacked in one op, as JAX's scan gives them.  JAX remats
    the layer scan; the port keeps every layer's activations instead:
    at a microbatch of 2 x 256 tokens they are small beside the float32
    training state, and remat changes memory, not numbers."""
    _check_family(cfg)
    x, rep = apply_embed(params["embed"], tokens, ctx)
    b, s, _ = x.shape
    positions = torch.arange(s, dtype=torch.int32,
                             device=x.device)[None].expand(b, s)
    kw = dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
              head_dim=cfg.head_dim_, positions=positions,
              rope_theta=cfg.rope_theta, use_rope=cfg.use_rope,
              prefix_global=cfg.meta_tokens, chunk=cfg.attn_chunk)
    caches = []
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    layers = unstack_layers(params["layers"], cfg.n_layers)
    for layer_p, window in zip(layers, _windows(cfg)):
        h = rmsnorm(layer_p["ln1"], x)
        if with_cache:
            a_out, cache_l, r_a = attn.attention_prefill(
                layer_p["attn"], h, ctx, cache_len=cache_len, window=window,
                **kw)
            caches.append({"attn": cache_l})
        else:
            a_out, r_a = attn.attention(layer_p["attn"], h, ctx, causal=True,
                                        window=window, **kw)
        x = x + a_out
        h2 = rmsnorm(layer_p["ln2"], x)
        f_out, aux_l, r_f = _ffn(layer_p, h2, ctx, cfg)
        x = x + f_out
        aux = aux + aux_l
        rep = policy.merge_reports(rep, r_a, r_f)
    x = rmsnorm(params["final_norm"], x)
    cache = stack_layers(caches) if with_cache else None
    return x, cache, rep, aux


def lm_logits(params, tokens, ctx: Ctx, cfg: ArchConfig):
    """Training forward: full logits [B, S, vocab_padded] (differentiable,
    as :func:`lm_hidden`)."""
    x, _, rep, aux = lm_hidden(params, tokens, ctx, cfg)
    logits, r_h = apply_linear(params["lm_head"], x, ctx, name="lm_head")
    return logits, policy.merge_reports(rep, r_h), aux


@torch.no_grad()
def lm_prefill(params, tokens, ctx: Ctx, cfg: ArchConfig, *,
               cache_len: int):
    """Prefill: last-position logits + the populated KV cache."""
    x, cache, rep, _ = lm_hidden(params, tokens, ctx, cfg, with_cache=True,
                                 cache_len=cache_len)
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
        new.append({"attn": new_attn})
        x = x + a_out
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
    """The zero bf16 cache, stacked ``[L, ...]``."""
    _check_family(cfg)
    shape = (cfg.n_layers, batch, cfg.n_kv_heads,
             cache_len + cfg.meta_tokens, cfg.head_dim_)
    return {"attn": {"k": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device),
                     "v": torch.zeros(shape, dtype=torch.bfloat16,
                                      device=device)}}
