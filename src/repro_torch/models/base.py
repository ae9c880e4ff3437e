"""Model facade: family dispatch, input specs and the loss function.

``Model(cfg, max_pos)`` exposes the JAX package's API over the families
the port has:

  init(seed, quant, dtype, device)            -> parameter tree
  loss(params, batch, ctx)                    -> (loss, (metrics, report))
  prefill(params, batch, ctx, cache_len)      -> (logits, cache, report)
  decode(params, cache, tokens, pos, ctx)     -> (logits, cache, report)
  init_cache(batch, cache_len, device)        -> zero cache tree
  input_specs(shape)                          -> {name: TensorSpec}

The decoder LMs (``dense``, ``moe``, the ``hybrid`` hymba and the
``vlm`` llava, :mod:`.lm`), the ``ssm`` family (RWKV6, :mod:`.rwkv`) and
the ``encdec`` whisper (:mod:`.whisper`, whose learned decoder positions
``max_pos`` sizes) serve and train; the ``dlrm`` family raises
:class:`NotImplementedError` naming its own model module.  RWKV's
recurrent state does not grow, so it ignores ``cache_len``.  ``init``
gives the float form unless ``quant`` asks for the int8 serving form, as
JAX's does.  ``loss`` is JAX's for every family: masked next-token cross
entropy (the meta-token and patch prefix labelled ``IGNORE``) plus 0.01
times the MoE load-balance loss.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.layers.common import Ctx
from repro_torch.models import lm, rwkv, whisper

#: the families the facade serves
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "encdec")

IGNORE = -1


class TensorSpec(NamedTuple):
    """A batch leaf's shape and dtype (JAX's ``ShapeDtypeStruct``)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype


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
    def __init__(self, cfg: ArchConfig, max_pos: int = 4096):
        if cfg.family not in FAMILIES:
            item = ("none: the DLRM is served by repro_torch.models.dlrm"
                    if cfg.family == "dlrm" else "unknown family")
            raise NotImplementedError(
                f"family {cfg.family!r} is not ported yet (ROADMAP "
                f"{item}); the facade serves {FAMILIES}")
        self.cfg = cfg
        self.max_pos = max_pos  # whisper's learned-position table size

    def init(self, seed: int, *, quant: bool = False,
             dtype=torch.float32, device="cuda"):
        """Random parameters from ``seed``: the float form in ``dtype``,
        or with ``quant`` the int8 serving form."""
        if self.cfg.family == "ssm":
            return rwkv.init_rwkv(seed, self.cfg, quant=quant, dtype=dtype,
                                  device=device)
        if self.cfg.family == "encdec":
            return whisper.init_whisper(seed, self.cfg, self.max_pos,
                                        quant=quant, dtype=dtype,
                                        device=device)
        return lm.init_lm(seed, self.cfg, quant=quant, dtype=dtype,
                          device=device)

    def loss(self, params, batch, ctx: Ctx):
        """Masked next-token cross entropy + 0.01 x the load-balance loss
        (0 but for ``moe``).  -> (loss, (metrics, report)); the metrics
        hold ``loss``, ``aux_loss`` and the report's counters."""
        cfg = self.cfg
        labels = batch["labels"]
        if cfg.family == "encdec":
            logits, rep, aux = whisper.whisper_logits(
                params, batch["frames"], batch["tokens"], ctx, cfg)
        elif cfg.family == "ssm":
            logits, rep, aux = rwkv.rwkv_logits(params, batch["tokens"],
                                                ctx, cfg)
        else:
            logits, rep, aux = lm.lm_logits(params, batch["tokens"], ctx,
                                            cfg, patches=batch.get("patches"))
            prefix = logits.shape[1] - labels.shape[1]
            if prefix > 0:   # vlm patches / hymba meta tokens: no loss there
                labels = torch.cat([torch.full(
                    (labels.shape[0], prefix), IGNORE, dtype=labels.dtype,
                    device=labels.device), labels], dim=1)
        loss = cross_entropy(logits, labels, cfg.vocab)
        loss = loss + 0.01 * aux
        metrics = {"loss": loss, "aux_loss": aux, **rep.as_metrics()}
        return loss, (metrics, rep)

    def prefill(self, params, batch, ctx: Ctx, cache_len: int):
        if self.cfg.family == "ssm":
            return rwkv.rwkv_prefill(params, batch["tokens"], ctx, self.cfg)
        if self.cfg.family == "encdec":
            return whisper.whisper_prefill(params, batch["frames"],
                                           batch["tokens"], ctx, self.cfg,
                                           cache_len=cache_len)
        return lm.lm_prefill(params, batch["tokens"], ctx, self.cfg,
                             cache_len=cache_len,
                             patches=batch.get("patches"))

    def decode(self, params, cache, tokens, pos, ctx: Ctx):
        if self.cfg.family == "ssm":
            return rwkv.rwkv_decode(params, cache, tokens, pos, ctx,
                                    self.cfg)
        if self.cfg.family == "encdec":
            return whisper.whisper_decode(params, cache, tokens, pos, ctx,
                                          self.cfg)
        return lm.lm_decode(params, cache, tokens, pos, ctx, self.cfg)

    def init_cache(self, batch: int, cache_len: int, *, device):
        """The zero cache (bf16 K/V; hymba's f32 SSM state, whisper's self
        and cross caches).  The serving engine does not call it: it
        widens each lane's first prefill cache, so a lane whose plan
        quantizes the cache gets QuantKV leaves."""
        if self.cfg.family == "ssm":
            return rwkv.init_rwkv_cache(self.cfg, batch, cache_len,
                                        device=device)
        if self.cfg.family == "encdec":
            return whisper.init_whisper_cache(self.cfg, batch, cache_len,
                                              device=device)
        return lm.init_lm_cache(self.cfg, batch, cache_len, device=device)

    def param_axes(self, *, quant: bool = False):
        """The logical axes of :meth:`init`'s tree, one tuple of names a
        leaf (JAX's ``LogicalParam`` axes;
        :func:`repro_torch.sharding.param_axes`)."""
        from repro_torch.sharding.logical import param_axes
        return param_axes(self.init(0, quant=quant, device="meta"))

    def train_state_axes(self, *, compress: bool = False):
        """The logical axes of the training state
        (:func:`repro_torch.launch.steps.init_train_state`; JAX's
        ``train_state_lp``)."""
        from repro_torch.sharding.logical import train_state_axes
        return train_state_axes(self.init(0, device="meta"),
                                compress=compress)

    def input_axes(self, shape) -> dict:
        """The logical axes of :meth:`input_specs` (JAX's
        ``input_specs`` leaves' axes): the batch first."""
        from repro_torch.sharding.logical import input_axes
        return input_axes(self.input_specs(shape))

    def input_specs(self, shape) -> dict:
        """{name: TensorSpec} of a batch of the shape suite ``shape``
        (a :class:`~repro_torch.configs.base.ShapeConfig`)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": TensorSpec((b,), torch.int32),
                    "pos": TensorSpec((b,), torch.int32)}
        specs = {}
        text_len = s
        if cfg.family == "vlm":
            text_len = s - cfg.n_patches
            specs["patches"] = TensorSpec((b, cfg.n_patches, cfg.patch_dim),
                                          torch.float32)
        if cfg.family == "hybrid":
            text_len = s - cfg.meta_tokens   # meta tokens count toward S
        if cfg.family == "encdec":
            specs["frames"] = TensorSpec((b, cfg.enc_seq, cfg.d_model),
                                         torch.float32)
        specs["tokens"] = TensorSpec((b, text_len), torch.int32)
        if shape.kind == "train":
            specs["labels"] = TensorSpec((b, text_len), torch.int32)
        return specs


def build_model(cfg: ArchConfig, max_pos: int = 4096) -> Model:
    return Model(cfg, max_pos=max_pos)
