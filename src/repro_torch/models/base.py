"""Model facade: family dispatch for serving, and the loss function.

``Model(cfg)`` exposes the JAX package's serving API over the families
the port has:

  init(seed, device)                          -> int8 parameter tree
  prefill(params, batch, ctx, cache_len)      -> (logits, cache, report)
  decode(params, cache, tokens, pos, ctx)     -> (logits, cache, report)
  init_cache(batch, cache_len, device)        -> zero cache tree

The ``dense`` and ``moe`` families (the decoder LMs, :mod:`.lm`) and
the ``ssm`` family (RWKV6, :mod:`.rwkv`) are ported; every other family
raises
:class:`NotImplementedError` naming the ROADMAP item that ports it, and
the serving engine relies on that refusal.  RWKV's recurrent state does
not grow, so it ignores ``cache_len``.  The training ``loss`` waits for
ROADMAP A6; :func:`cross_entropy` is its loss.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.common import Ctx
from repro_torch.models import lm, rwkv

#: ROADMAP items that port each family the facade does not serve yet
_NOT_PORTED = {
    "vlm": "A7 (llava)",
    "encdec": "A7 (whisper)",
    "hybrid": "A7 (mamba / hymba)",
    "dlrm": "none: the DLRM is served by repro_torch.models.dlrm",
}

IGNORE = -1


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab: int) -> torch.Tensor:
    """Masked CE over the padded vocabulary: labels outside ``[0, vocab)``
    (``IGNORE`` among them) are left out of the mean."""
    lf = logits.to(torch.float32)
    mask = (labels >= 0) & (labels < vocab)
    safe = torch.clamp(labels, 0, lf.shape[-1] - 1).long()
    lse = torch.logsumexp(lf, dim=-1)
    tgt = torch.gather(lf, -1, safe[..., None])[..., 0]
    ce = (lse - tgt) * mask
    return torch.sum(ce) / torch.clamp(torch.sum(mask), min=1)


class Model:
    def __init__(self, cfg: ArchConfig):
        if cfg.family not in ("dense", "moe", "ssm"):
            item = _NOT_PORTED.get(cfg.family, "unknown family")
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP "
                f"{item}); the facade serves 'dense', 'moe' and 'ssm'")
        self.cfg = cfg

    def init(self, seed: int, *, device="cuda"):
        """The int8 serving form (the float LM: :func:`lm.init_lm`)."""
        if self.cfg.family == "ssm":
            return rwkv.init_rwkv(seed, self.cfg, device=device)
        return lm.init_lm(seed, self.cfg, quant=True, device=device)

    def prefill(self, params, batch, ctx: Ctx, cache_len: int):
        if self.cfg.family == "ssm":
            return rwkv.rwkv_prefill(params, batch["tokens"], ctx, self.cfg)
        return lm.lm_prefill(params, batch["tokens"], ctx, self.cfg,
                             cache_len=cache_len)

    def decode(self, params, cache, tokens, pos, ctx: Ctx):
        if self.cfg.family == "ssm":
            return rwkv.rwkv_decode(params, cache, tokens, pos, ctx,
                                    self.cfg)
        return lm.lm_decode(params, cache, tokens, pos, ctx, self.cfg)

    def init_cache(self, batch: int, cache_len: int, *, device):
        """The zero cache (bf16 K/V for ``dense``).  The serving engine
        does not call it: it widens each lane's first prefill cache, so a
        lane whose plan quantizes the cache gets QuantKV leaves."""
        if self.cfg.family == "ssm":
            return rwkv.init_rwkv_state_values(self.cfg, batch,
                                               device=device)
        return lm.init_lm_cache(self.cfg, batch, cache_len, device=device)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
