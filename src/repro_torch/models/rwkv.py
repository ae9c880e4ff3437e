"""RWKV6 (Finch) language model: stacked time-mix + channel-mix blocks,
in the int8 serving form (ABFT on every projection and on the token
embedding) or the float training form, as the JAX package's
``models/rwkv.py``.

The parameter and state trees keep the JAX package's layout, so
:func:`repro_torch.models.convert.from_jax` carries its weights over
unchanged and one request's state drops into a serving slot as it does
there:

* per-layer parameters are stacked on a leading ``[L, ...]`` axis (the
  JAX model vmaps its layer init and scans over layers; here the layer
  loop is written out and indexes the stack);
* the recurrent state ("cache") is ``S [L, B, H, dh, dh]``,
  ``x_tm [L, B, d]`` and ``x_cm [L, B, d]``, all float32.

Decode state is O(1) per layer: the "KV cache" never grows.  The
training forward (:func:`rwkv_logits`) keeps every layer's activations,
where JAX remats its layer scan (the same numbers, more memory).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import policy
from repro_torch.device import resolve_device
from repro_torch.layers import rwkv6 as rk
from repro_torch.layers.common import (Ctx, init_stacked, layer_at,
                                       stack_layers, unstack_layers)
from repro_torch.layers.embedding import apply_embed, init_embed, init_qembed
from repro_torch.layers.linear import apply_linear, maybe_qlinear_init
from repro_torch.layers.norms import init_layernorm, layernorm
from repro_torch.sharding.logical import constrain


def _init_layer(gen, cfg: ArchConfig, quant: bool, dtype, device):
    return {
        "ln1": init_layernorm(cfg.d_model, device=device, dtype=dtype),
        "tm": rk.init_timemix(gen, cfg.d_model, cfg.n_heads, device=device,
                              quant=quant, dtype=dtype),
        "ln2": init_layernorm(cfg.d_model, device=device, dtype=dtype),
        "cm": rk.init_channelmix(gen, cfg.d_model, cfg.d_ff, device=device,
                                 quant=quant, dtype=dtype),
    }


@torch.no_grad()
def init_rwkv(seed: int, cfg: ArchConfig, *, quant: bool = False,
              dtype=torch.float32, device="cuda"):
    """Random RWKV6 parameters from ``seed``, made on ``device``: the
    float form in ``dtype``, or with ``quant`` the int8 serving form.

    The JAX ``init_rwkv``'s distributions (not its values: the generators
    differ): float parameters normal times the JAX ``param()`` scale (0.5
    for ``mu``, ``w0``, ``bonus``; 0.02 for the decay LoRA and the float
    token table), layer norms at scale 1 and bias 0, the projections and
    head without bias (int8 as :func:`init_qlinear`, float ``w`` at
    ``d_in ** -0.5``), the token table over the padded vocabulary.
    ``device="meta"`` gives the tree's shapes and dtypes without
    storage."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    vp = cfg.vocab_padded
    embed = (init_qembed(gen, vp, cfg.d_model, device=dev) if quant
             else init_embed(gen, vp, cfg.d_model, dtype=dtype, device=dev))
    return {
        "embed": embed,
        "ln0": init_layernorm(cfg.d_model, device=dev, dtype=dtype),
        "layers": init_stacked(lambda: _init_layer(gen, cfg, quant, dtype,
                                                   dev), cfg.n_layers),
        "ln_out": init_layernorm(cfg.d_model, device=dev, dtype=dtype),
        "head": maybe_qlinear_init(gen, cfg.d_model, vp, quant, dtype,
                                   bias=False, device=dev),
    }


def _block(layer_p, x, state, ctx: Ctx, cfg: ArchConfig):
    """x [B,S,d] + per-layer state -> (x', new_state, report)."""
    h = layernorm(layer_p["ln1"], x)
    y, x_tm, s_new, r1 = rk.timemix(
        layer_p["tm"], h, state["x_tm"].to(h.dtype), state["S"], ctx,
        n_heads=cfg.n_heads)
    x = x + y
    h2 = layernorm(layer_p["ln2"], x)
    y2, x_cm, r2 = rk.channelmix(layer_p["cm"], h2,
                                 state["x_cm"].to(h2.dtype), ctx)
    x = x + y2
    new_state = {"S": s_new, "x_tm": x_tm.to(torch.float32),
                 "x_cm": x_cm.to(torch.float32)}
    return x, new_state, policy.merge_reports(r1, r2)


def _layers(params, x, states, ctx: Ctx, cfg: ArchConfig, rep):
    """Every block in order, from the stacked ``states``; returns the new
    stacked states.  The stacks are unbound once (``unstack_layers``), so
    the layers' gradients stack in one op, as JAX's scan gives them."""
    new = []
    layers = unstack_layers(params["layers"], cfg.n_layers)
    for i, layer_p in enumerate(layers):
        x, st, r = _block(layer_p, x, layer_at(states, i), ctx, cfg)
        x = constrain(x, ("batch", "seq", None), ctx.rules)
        rep = policy.merge_reports(rep, r)
        new.append(st)
    return x, stack_layers(new), rep


def rwkv_hidden(params, tokens, ctx: Ctx, cfg: ArchConfig, states=None):
    """tokens [B,S] from stacked ``states`` (zero states if None) ->
    (final-normed hidden [B,S,d], new states, report).  Differentiable:
    the training loss takes its gradient through it; the serving entry
    points call it under ``torch.no_grad``."""
    if states is None:
        states = init_rwkv_state_values(cfg, tokens.shape[0],
                                        device=tokens.device)
    x, rep = apply_embed(params["embed"], tokens, ctx)
    x = layernorm(params["ln0"], x)
    x = constrain(x, ("batch", "seq", None), ctx.rules)
    x, new_states, rep = _layers(params, x, states, ctx, cfg, rep)
    return layernorm(params["ln_out"], x), new_states, rep


def rwkv_logits(params, tokens, ctx: Ctx, cfg: ArchConfig):
    """Training forward: logits [B, S, vocab_padded], report and the aux
    loss (0: RWKV has no MoE)."""
    x, _, rep = rwkv_hidden(params, tokens, ctx, cfg)
    logits, r_h = apply_linear(params["head"], x, ctx, name="lm_head")
    logits = constrain(logits, ("batch", "seq", "vocab"), ctx.rules)
    return logits, policy.merge_reports(rep, r_h), \
        torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def rwkv_prefill(params, tokens, ctx: Ctx, cfg: ArchConfig):
    """Returns last-token logits + the recurrent state as 'cache'."""
    x, states, rep = rwkv_hidden(params, tokens, ctx, cfg)
    logits, r_h = apply_linear(params["head"], x[:, -1, :], ctx,
                               name="lm_head")
    return logits, states, policy.merge_reports(rep, r_h)


@torch.no_grad()
def rwkv_decode(params, cache, tokens, pos, ctx: Ctx, cfg: ArchConfig):
    """One token per row; cache = stacked per-layer states.  ``pos`` is
    unused (the state is recurrent)."""
    del pos
    x, rep = apply_embed(params["embed"], tokens, ctx)
    x = layernorm(params["ln0"], x[:, None, :])
    x, new_states, rep = _layers(params, x, cache, ctx, cfg, rep)
    x = layernorm(params["ln_out"], x[:, 0, :])
    logits, r_h = apply_linear(params["head"], x, ctx, name="lm_head")
    return logits, new_states, policy.merge_reports(rep, r_h)


def init_rwkv_state_values(cfg: ArchConfig, batch: int, *, device):
    """Zero stacked states ``[L, ...]`` for ``batch`` rows."""
    dh = cfg.d_model // cfg.n_heads
    L = cfg.n_layers
    return {
        "S": torch.zeros((L, batch, cfg.n_heads, dh, dh), device=device),
        "x_tm": torch.zeros((L, batch, cfg.d_model), device=device),
        "x_cm": torch.zeros((L, batch, cfg.d_model), device=device),
    }


def init_rwkv_cache(cfg: ArchConfig, batch: int, cache_len: int,
                    dtype=torch.bfloat16, *, device):
    """The zero recurrent state (JAX's ``init_rwkv_cache``): ``cache_len``
    and ``dtype`` are irrelevant, the state is O(1) and float32."""
    del cache_len, dtype
    return init_rwkv_state_values(cfg, batch, device=device)
