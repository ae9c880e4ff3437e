"""Whisper-style encoder-decoder backbone (conv/mel frontend stubbed) —
the JAX package's ``models/whisper.py``.

Encoder: precomputed frame embeddings [B, T_enc, d] + sinusoid
positions, non-causal self-attention, GeLU MLP.  Decoder: learned
positions, causal self-attention + cross-attention over the encoder
memory.  LayerNorm everywhere, no RoPE; every linear carries a bias.

The tree is JAX's: ``enc`` {``layers``, ``ln_post``} and ``dec``
{``embed``, ``pos``, ``layers``, ``ln``, ``head``}, every per-layer leaf
stacked on a leading ``[L, ...]`` axis.  The decode cache is ``self``
(the decoder's KV cache, bf16 or :class:`~repro_torch.core.QuantKV`
where the plan enables ``kv_cache``) and ``cross`` (the encoder memory's
K and V, bf16, written once at the prefill), leaves ``[L, B, Kv, S,
dh]``.  The calls keep JAX's order, the prefill's second ``cross.wk`` /
``cross.wv`` product on the memory for the cache included, so the
FaultReport counters equal JAX's call for call.

``max_pos`` sizes the decoder's learned position table.  A position past
it reads the table's last row, as JAX's clamped gather does (a retired
slot's position keeps counting in the engine's decode batch).
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.core import policy
from repro_torch.device import resolve_device
from repro_torch.layers import attention as attn
from repro_torch.layers.common import (Ctx, init_stacked, layer_at,
                                       stack_layers, unstack_layers)
from repro_torch.layers.embedding import apply_embed, init_embed, init_qembed
from repro_torch.layers.linear import apply_linear, maybe_qlinear_init
from repro_torch.layers.mlp import init_mlp, mlp
from repro_torch.layers.norms import init_layernorm, layernorm
from repro_torch.layers.rope import sinusoid_positions
from repro_torch.sharding.logical import constrain


def _attn_init(gen, cfg: ArchConfig, quant, dtype, device):
    return attn.init_attention(gen, cfg.d_model, cfg.n_heads,
                               cfg.n_kv_heads, cfg.head_dim_, quant=quant,
                               dtype=dtype, bias=True, device=device)


def _mlp_init(gen, cfg: ArchConfig, quant, dtype, device):
    return init_mlp(gen, cfg.d_model, cfg.d_ff, gated=False, quant=quant,
                    dtype=dtype, bias=True, device=device)


def _init_enc_layer(gen, cfg: ArchConfig, quant, dtype, device):
    d = cfg.d_model
    return {"ln1": init_layernorm(d, dtype=dtype, device=device),
            "attn": _attn_init(gen, cfg, quant, dtype, device),
            "ln2": init_layernorm(d, dtype=dtype, device=device),
            "mlp": _mlp_init(gen, cfg, quant, dtype, device)}


def _init_dec_layer(gen, cfg: ArchConfig, quant, dtype, device):
    d = cfg.d_model
    return {"ln1": init_layernorm(d, dtype=dtype, device=device),
            "self": _attn_init(gen, cfg, quant, dtype, device),
            "ln2": init_layernorm(d, dtype=dtype, device=device),
            "cross": _attn_init(gen, cfg, quant, dtype, device),
            "ln3": init_layernorm(d, dtype=dtype, device=device),
            "mlp": _mlp_init(gen, cfg, quant, dtype, device)}


@torch.no_grad()
def init_whisper(seed: int, cfg: ArchConfig, max_pos: int,
                 quant: bool = False, dtype=torch.float32, *,
                 device="cuda"):
    """Random whisper parameters from ``seed`` on ``device``: the JAX
    ``init_whisper``'s tree and distributions (not its values: the
    generators differ); ``quant`` gives the int8 serving form."""
    dev = torch.device("meta") if str(device) == "meta" \
        else resolve_device(device)
    gen = torch.Generator(device="cpu" if dev.type == "meta" else dev
                          ).manual_seed(seed)
    vp, d = cfg.vocab_padded, cfg.d_model
    enc_layers = init_stacked(
        lambda: _init_enc_layer(gen, cfg, quant, dtype, dev), cfg.enc_layers)
    dec_layers = init_stacked(
        lambda: _init_dec_layer(gen, cfg, quant, dtype, dev), cfg.n_layers)
    embed = (init_qembed(gen, vp, d, device=dev) if quant
             else init_embed(gen, vp, d, dtype=dtype, device=dev))
    pos = (torch.randn((max_pos, d), generator=gen, device=dev,
                       dtype=torch.float32) * 0.02).to(dtype)
    return {
        "enc": {"layers": enc_layers,
                "ln_post": init_layernorm(d, dtype=dtype, device=dev)},
        "dec": {"embed": embed, "pos": pos, "layers": dec_layers,
                "ln": init_layernorm(d, dtype=dtype, device=dev),
                "head": maybe_qlinear_init(gen, d, vp, quant, dtype,
                                           bias=False, device=dev)},
    }


def _heads(cfg: ArchConfig) -> dict:
    return dict(n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
                head_dim=cfg.head_dim_)


def encode(params, frames, ctx: Ctx, cfg: ArchConfig):
    """frames [B, T, d] (the stub frontend's output) -> (memory [B,T,d],
    report)."""
    b, t, d = frames.shape
    x = frames.to(ctx.compute_dtype) + sinusoid_positions(
        t, d, device=frames.device).to(ctx.compute_dtype)[None]
    x = constrain(x, ("batch", "seq", None), ctx.rules)
    positions = torch.arange(t, dtype=torch.int32,
                             device=frames.device)[None].expand(b, t)
    rep = policy.empty_report()
    for layer_p in unstack_layers(params["enc"]["layers"], cfg.enc_layers):
        h = layernorm(layer_p["ln1"], x)
        a, r1 = attn.attention(layer_p["attn"], h, ctx, positions=positions,
                               use_rope=False, causal=False,
                               chunk=cfg.attn_chunk, **_heads(cfg))
        x = x + a
        f, r2 = mlp(layer_p["mlp"], layernorm(layer_p["ln2"], x), ctx)
        x = x + f
        rep = policy.merge_reports(rep, r1, r2)
    return layernorm(params["enc"]["ln_post"], x), rep


def _pos_rows(params, positions: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """The learned position rows, indices clamped into the table."""
    tab = params["dec"]["pos"].to(ctx.compute_dtype)
    return tab[torch.clamp(positions.long(), 0, tab.shape[0] - 1)]


def _dec_embed(params, tokens, positions, ctx: Ctx):
    x, rep = apply_embed(params["dec"]["embed"], tokens, ctx)
    return x + _pos_rows(params, positions, ctx), rep


def decode_train(params, tokens, memory, ctx: Ctx, cfg: ArchConfig,
                 with_cache: bool = False, cache_len: int = 0):
    """Teacher-forced decoder pass.  Returns (x, cache | None, report);
    with ``with_cache`` the self-attention cache is padded to
    ``cache_len`` and the cross cache holds the memory's K and V."""
    b, s = tokens.shape
    t_enc = memory.shape[1]
    dev = tokens.device
    positions = torch.arange(s, dtype=torch.int32, device=dev)[None].expand(
        b, s)
    mem_pos = torch.arange(t_enc, dtype=torch.int32,
                           device=dev)[None].expand(b, t_enc)
    x, rep = _dec_embed(params, tokens, positions, ctx)
    x = constrain(x, ("batch", "seq", None), ctx.rules)
    heads = _heads(cfg)
    caches = []
    for layer_p in unstack_layers(params["dec"]["layers"], cfg.n_layers):
        h = layernorm(layer_p["ln1"], x)
        if with_cache:
            a, kv, r1 = attn.attention_prefill(
                layer_p["self"], h, ctx, positions=positions,
                cache_len=cache_len, use_rope=False, chunk=cfg.attn_chunk,
                **heads)
        else:
            a, r1 = attn.attention(layer_p["self"], h, ctx,
                                   positions=positions, use_rope=False,
                                   causal=True, chunk=cfg.attn_chunk,
                                   **heads)
        x = x + a
        h2 = layernorm(layer_p["ln2"], x)
        c, r2 = attn.attention(layer_p["cross"], h2, ctx, positions=positions,
                               use_rope=False, causal=False, x_kv=memory,
                               kv_positions=mem_pos, chunk=cfg.attn_chunk,
                               **heads)
        x = x + c
        f, r3 = mlp(layer_p["mlp"], layernorm(layer_p["ln3"], x), ctx)
        x = x + f
        if with_cache:
            # the static cross K/V the decode steps read
            ck, rk = apply_linear(layer_p["cross"]["wk"], memory, ctx,
                                  name="cross.wk")
            cv, rv = apply_linear(layer_p["cross"]["wv"], memory, ctx,
                                  name="cross.wv")
            shape = (b, t_enc, cfg.n_kv_heads, cfg.head_dim_)
            caches.append({"self": kv,
                           "cross": {"k": ck.reshape(shape).transpose(1, 2),
                                     "v": cv.reshape(shape).transpose(1, 2)}})
            rep = policy.merge_reports(rep, rk, rv)
        rep = policy.merge_reports(rep, r1, r2, r3)
    x = layernorm(params["dec"]["ln"], x)
    return x, (stack_layers(caches) if with_cache else None), rep


def whisper_logits(params, frames, tokens, ctx: Ctx, cfg: ArchConfig):
    """The full forward: logits [B, S, vocab_padded], report, aux (0)."""
    memory, r_enc = encode(params, frames, ctx, cfg)
    x, _, r_dec = decode_train(params, tokens, memory, ctx, cfg)
    logits, r_h = apply_linear(params["dec"]["head"], x, ctx, name="lm_head")
    logits = constrain(logits, ("batch", "seq", "vocab"), ctx.rules)
    return logits, policy.merge_reports(r_enc, r_dec, r_h), \
        torch.zeros((), dtype=torch.float32, device=x.device)


@torch.no_grad()
def whisper_prefill(params, frames, tokens, ctx: Ctx, cfg: ArchConfig, *,
                    cache_len: int):
    """Encode, then the decoder over the prompt: last-position logits and
    the self and cross caches."""
    memory, r_enc = encode(params, frames, ctx, cfg)
    x, cache, r_dec = decode_train(params, tokens, memory, ctx, cfg,
                                   with_cache=True, cache_len=cache_len)
    logits, r_h = apply_linear(params["dec"]["head"], x[:, -1, :], ctx,
                               name="lm_head")
    return logits, cache, policy.merge_reports(r_enc, r_dec, r_h)


@torch.no_grad()
def whisper_decode(params, cache, tokens, pos, ctx: Ctx, cfg: ArchConfig):
    """One decoder token against the self and (static) cross caches.
    tokens [B] int32, pos [B] int32.  Returns (logits, cache, report);
    the cross cache comes back as it went in."""
    x, rep = apply_embed(params["dec"]["embed"], tokens, ctx)
    x = x + _pos_rows(params, pos, ctx)
    heads = _heads(cfg)
    new_self = []
    for i in range(cfg.n_layers):
        layer_p = layer_at(params["dec"]["layers"], i)
        h = layernorm(layer_p["ln1"], x)
        a, self_l, r1 = attn.attention_decode(
            layer_p["self"], h, layer_at(cache["self"], i), pos, ctx,
            use_rope=False, **heads)
        new_self.append(self_l)
        x = x + a
        h2 = layernorm(layer_p["ln2"], x)
        c, _, r2 = attn.attention_decode(
            layer_p["cross"], h2, layer_at(cache["cross"], i), pos, ctx,
            use_rope=False, cross=True, **heads)
        x = x + c
        f, r3 = mlp(layer_p["mlp"], layernorm(layer_p["ln3"], x)[:, None, :],
                    ctx)
        x = x + f[:, 0, :]
        rep = policy.merge_reports(rep, r1, r2, r3)
    x = layernorm(params["dec"]["ln"], x)
    logits, r_h = apply_linear(params["dec"]["head"], x, ctx, name="lm_head")
    return logits, {"self": stack_layers(new_self),
                    "cross": cache["cross"]}, policy.merge_reports(rep, r_h)


def init_whisper_cache(cfg: ArchConfig, batch: int, cache_len: int, *,
                       device, dtype=torch.bfloat16):
    """The zero cache: ``self`` over ``cache_len`` positions and
    ``cross`` over the encoder's ``enc_seq``."""
    def kv(seq):
        shape = (cfg.n_layers, batch, cfg.n_kv_heads, seq, cfg.head_dim_)
        return {"k": torch.zeros(shape, dtype=dtype, device=device),
                "v": torch.zeros(shape, dtype=dtype, device=device)}
    return {"self": kv(cache_len), "cross": kv(cfg.enc_seq)}
