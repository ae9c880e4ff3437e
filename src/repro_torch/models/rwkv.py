"""RWKV6 (Finch) language model: stacked time-mix + channel-mix blocks,
int8-quantized with ABFT on every projection and on the token embedding.

The parameter and state trees keep the JAX package's layout, so
:func:`repro_torch.models.convert.from_jax` carries its weights over
unchanged and one request's state drops into a serving slot as it does
there:

* per-layer parameters are stacked on a leading ``[L, ...]`` axis (the
  JAX model vmaps its layer init and scans over layers; here the layer
  loop is written out and indexes the stack);
* the recurrent state ("cache") is ``S [L, B, H, dh, dh]``,
  ``x_tm [L, B, d]`` and ``x_cm [L, B, d]``, all float32.

Decode state is O(1) per layer: the "KV cache" never grows.  The training
forward (``rwkv_logits``) waits for ROADMAP A7.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import policy
from repro_torch.device import resolve_device
from repro_torch.layers import rwkv6 as rk
from repro_torch.layers.common import Ctx, layer_at, stack_layers
from repro_torch.layers.embedding import apply_embed, init_qembed
from repro_torch.layers.linear import apply_linear, init_qlinear
from repro_torch.layers.norms import init_layernorm, layernorm


def _init_layer(gen, cfg: ArchConfig, device):
    return {
        "ln1": init_layernorm(cfg.d_model, device=device),
        "tm": rk.init_timemix(gen, cfg.d_model, cfg.n_heads, device=device),
        "ln2": init_layernorm(cfg.d_model, device=device),
        "cm": rk.init_channelmix(gen, cfg.d_model, cfg.d_ff, device=device),
    }


@torch.no_grad()
def init_rwkv(seed: int, cfg: ArchConfig, *, device="cuda"):
    """Random int8 RWKV6 parameters from ``seed``, made on ``device``.

    The JAX ``init_rwkv(..., quant=True)`` distributions (not its values:
    the generators differ): float parameters normal times the JAX
    ``param()`` scale (0.5 for ``mu``, ``w0``, ``bonus``; 0.02 for the
    decay LoRA), layer norms at scale 1 and bias 0, int8 projections
    and head as :func:`init_qlinear` without bias, the token table as
    :func:`init_qembed` over the padded vocabulary."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    vp = cfg.vocab_padded
    return {
        "embed": init_qembed(gen, vp, cfg.d_model, device=dev),
        "ln0": init_layernorm(cfg.d_model, device=dev),
        "layers": stack_layers([_init_layer(gen, cfg, dev)
                          for _ in range(cfg.n_layers)]),
        "ln_out": init_layernorm(cfg.d_model, device=dev),
        "head": init_qlinear(gen, cfg.d_model, vp, bias=False, device=dev),
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
    stacked states."""
    new = []
    for i in range(cfg.n_layers):
        x, st, r = _block(layer_at(params["layers"], i), x,
                          layer_at(states, i), ctx, cfg)
        rep = policy.merge_reports(rep, r)
        new.append(st)
    return x, stack_layers(new), rep


@torch.no_grad()
def rwkv_hidden(params, tokens, states, ctx: Ctx, cfg: ArchConfig):
    """tokens [B,S] from stacked ``states`` -> (final-normed hidden
    [B,S,d], new states, report)."""
    x, rep = apply_embed(params["embed"], tokens, ctx)
    x = layernorm(params["ln0"], x)
    x, new_states, rep = _layers(params, x, states, ctx, cfg, rep)
    return layernorm(params["ln_out"], x), new_states, rep


@torch.no_grad()
def rwkv_prefill(params, tokens, ctx: Ctx, cfg: ArchConfig):
    """Returns last-token logits + the recurrent state as 'cache'."""
    states = init_rwkv_state_values(cfg, tokens.shape[0],
                                    device=tokens.device)
    x, states, rep = rwkv_hidden(params, tokens, states, ctx, cfg)
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
