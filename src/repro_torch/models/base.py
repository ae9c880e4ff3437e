"""Model facade: family dispatch for serving.

``Model(cfg)`` exposes the JAX package's serving API over the families
the port has:

  init(seed, device)                          -> parameter tree
  prefill(params, batch, ctx)                 -> (logits, cache, report)
  decode(params, cache, tokens, pos, ctx)     -> (logits, cache, report)
  init_cache(batch, device)                   -> zero cache tree

Only the ``ssm`` family (RWKV6) is ported; every other family raises
:class:`NotImplementedError` naming the ROADMAP item that ports it, and
the serving engine relies on that refusal.  The recurrent state does not
grow, so neither ``prefill`` nor ``init_cache`` takes the JAX facade's
``cache_len``: it comes back with the KV-cache families (ROADMAP A8).
The training ``loss`` waits for ROADMAP A10.
"""
from __future__ import annotations

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.common import Ctx
from repro_torch.models import rwkv

#: ROADMAP items that port each family the facade does not serve yet
_NOT_PORTED = {
    "dense": "A8 (LM decode and serving)",
    "moe": "A8 (LM decode and serving)",
    "vlm": "A8 (LM decode and serving)",
    "encdec": "A11 (whisper)",
    "hybrid": "A11 (mamba / hymba)",
    "dlrm": "none: the DLRM is served by repro_torch.models.dlrm",
}


class Model:
    def __init__(self, cfg: ArchConfig):
        if cfg.family != "ssm":
            item = _NOT_PORTED.get(cfg.family, "unknown family")
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP "
                f"{item}); the facade serves 'ssm'")
        self.cfg = cfg

    def init(self, seed: int, *, device="cuda"):
        return rwkv.init_rwkv(seed, self.cfg, device=device)

    def prefill(self, params, batch, ctx: Ctx):
        return rwkv.rwkv_prefill(params, batch["tokens"], ctx, self.cfg)

    def decode(self, params, cache, tokens, pos, ctx: Ctx):
        return rwkv.rwkv_decode(params, cache, tokens, pos, ctx, self.cfg)

    def init_cache(self, batch: int, *, device):
        return rwkv.init_rwkv_state_values(self.cfg, batch, device=device)


def build_model(cfg: ArchConfig) -> Model:
    return Model(cfg)
