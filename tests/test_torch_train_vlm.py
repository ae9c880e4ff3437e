"""Training llava-next-mistral-7b's reduced model (the VLM: stub patch
features through the two-layer projector before the text) in the port
against the JAX package, on the CPU.

* ``Model.loss`` and every gradient leaf against
  ``jax.value_and_grad(Model.loss)`` on JAX's weights: the loss within
  1e-5 (f32) or 2^-7 (bf16), each leaf (the projector's among them)
  within 2^-7 of its largest magnitude in float32 compute (the bf16
  attention's cotangents, ROADMAP §C10) and 2^-6 in bf16 compute
  (§C13: the projector's bias gradients are bf16 sums over the
  patches, which XLA adds in bf16).
* The labels are padded with ``IGNORE`` over the patch prefix: the loss
  is the cross entropy of the text positions alone.
"""
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch.layers.common import Ctx  # noqa: E402
from repro_torch.models import base as t_base  # noqa: E402
from repro_torch.models import lm as t_lm  # noqa: E402
from repro_torch.models.convert import from_jax  # noqa: E402

from torch_family_parity import (check_loss_and_grads,  # noqa: E402
                                 train_batch, train_cfgs, train_weights)

ARCH = "llava-next-mistral-7b"


@pytest.mark.parametrize("dtype,seed", [("float32", 0), ("float32", 1),
                                        ("bfloat16", 0), ("bfloat16", 1)])
def test_loss_and_grads_against_jax(dtype, seed):
    (_, jmet), (_, tmet) = check_loss_and_grads(ARCH, dtype, seed)
    assert jmet["aux_loss"] == tmet["aux_loss"] == 0.0


def test_patch_prefix_has_no_loss():
    cfg = train_cfgs(ARCH)[1]
    params = from_jax(train_weights(ARCH, 0), "cpu")
    batch = from_jax(train_batch(cfg, 0), "cpu")
    ctx = Ctx(quant=False, compute_dtype=torch.float32)
    loss, _ = t_base.Model(cfg).loss(params, batch, ctx)
    logits, _, _ = t_lm.lm_logits(params, batch["tokens"], ctx, cfg,
                                  patches=batch["patches"])
    assert logits.shape[1] == cfg.n_patches + batch["tokens"].shape[1]
    text = logits[:, cfg.n_patches:]
    want = t_base.cross_entropy(text, batch["labels"], cfg.vocab)
    assert float(loss) == float(want)
