"""Serving steps over the model facade: greedy next token plus the
step's fault metrics (the JAX ``launch/steps.py`` serving half; the
training steps wait for ROADMAP A6)."""
from __future__ import annotations

import torch

from repro_torch.layers.common import Ctx
from repro_torch.models.base import Model


def _greedy(model: Model, logits: torch.Tensor) -> torch.Tensor:
    """Argmax over the real vocabulary (the padding columns excluded)."""
    return torch.argmax(logits[..., :model.cfg.vocab],
                        dim=-1).to(torch.int32)


def make_prefill_step(model: Model, ctx: Ctx, cache_len: int):
    """(params, batch) -> (next_token [B] int32, cache, metrics); the KV
    cache is padded to ``cache_len`` positions (a paged lane passes its
    prompt bucket, so nothing is padded: the engine packs the rows into
    pool pages)."""

    def prefill_step(params, batch):
        logits, cache, rep = model.prefill(params, batch, ctx, cache_len)
        return _greedy(model, logits), cache, rep.as_metrics()

    return prefill_step


def make_decode_step(model: Model, ctx: Ctx):
    """(params, cache, tokens [B], pos [B]) -> (next [B], cache, metrics);
    a paged cache comes back as the same pools, written in place."""

    def decode_step(params, cache, tokens, pos):
        logits, new_cache, rep = model.decode(params, cache, tokens, pos,
                                              ctx)
        return _greedy(model, logits), new_cache, rep.as_metrics()

    return decode_step
