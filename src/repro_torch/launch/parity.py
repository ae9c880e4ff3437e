"""How closely two runs of one training step must agree: the port
against the JAX package on the CPU, and the card against the CPU.  Each
bound is a share of a magnitude: the loss's of its value, a gradient
leaf's error of :func:`grad_scale`.  One rule for the CPU tests and for
``chip_smoke.py``'s card runs (ROADMAP §C10, §C13)."""
from __future__ import annotations


def grad_scale(path: str, grads) -> float:
    """The magnitude a gradient leaf's error is held against: its own
    largest (``grads`` maps dotted paths to tensors or arrays).  A key
    projection's bias has no gradient in exact arithmetic (a row's
    logits all shift by q·b, which the softmax ignores): both runs give
    round-off there, held against the ``wk.w`` leaf's scale."""
    if path.endswith("wk.b"):
        path = path[:-1] + "w"
    return max(float(abs(grads[path]).max()), 1e-30)


def grad_tolerance(cfg, dtype: str) -> float:
    """A gradient leaf's tolerance, a share of :func:`grad_scale`.
    float32 compute: 2**-7 where the bf16 attention's cotangents reach
    the leaf (§C10: every leaf of a model with attention); RWKV has
    none, so its leaves, the decay LoRA's among them, are held to 1e-5.
    bf16 compute: 2**-6, whisper's 2**-5 (§C13: the bias, token and
    SSM-input gradients are sums over the bf16 rows, which XLA adds in
    bf16 and PyTorch in float32, and cuBLAS and the CPU in other orders:
    up to 1.08 × 2**-7 measured, and whisper's ~2**-6, where every
    linear has a bias)."""
    if dtype == "float32":
        return 1e-5 if cfg.family == "ssm" else 2.0 ** -7
    return 2.0 ** -5 if cfg.family == "encdec" else 2.0 ** -6


def loss_tolerance(cfg, dtype: str, *, card: bool = False,
                   sharded: bool = False) -> float:
    """The loss's tolerance, a share of its value: 1e-5 in float32
    compute, 2**-7 in bf16.  Card against CPU, the MoE's float32 loss
    is held to 1e-4: its dispatch and combine round the expert rows and
    gate values to bf16 (as JAX's do), so an f32 ulp upstream that
    cuBLAS sums in another order can flip a bf16 rounding.  A model
    mesh's step (``sharded``) sums a row-parallel product's partials in
    another order too, so its MoE loss is held to 1e-4 alike (ROADMAP
    §C19)."""
    if dtype != "float32":
        return 2.0 ** -7
    return 1e-4 if (card or sharded) and cfg.family == "moe" else 1e-5


def adam_step_tolerance(lr: float, steps: int) -> float:
    """An absolute bound on a parameter after ``steps`` AdamW steps of
    two runs whose gradients differ by round-off (a bf16 cotangent, an
    int8 code one apart at a rounding boundary): Adam normalizes each
    element's step, so an element whose gradient is near zero (or whose
    code splits between 0 and ±1) may step by up to ``lr`` either way in
    one run and not in the other, 2·``lr`` a step at most."""
    return 2.0 * lr * steps


def trained_loss_tolerance(cfg, dtype: str) -> float:
    """The loss's tolerance after one or more AdamW steps of two runs
    whose gradients differ by round-off (a mesh's partial sums against
    one device's, the port against JAX: §C10): each element whose
    gradient is near zero may step by up to ``lr`` in one run and not in
    the other (:func:`adam_step_tolerance`), and the next loss moves
    with them.  float32: 1e-4 (JAX's own (2, 2) and (1, 1) steps of the
    reduced Llama part by 2.0e-5 of the loss after one step, the port's
    (2, 2) step from JAX's by up to 2.8e-5); a MoE's 1e-3 (its dispatch
    rounds rows to bf16, §C19: the reduced granite's one-device port
    and JAX steps part by 4.2e-4 after one); bf16 2**-7."""
    if dtype != "float32":
        return 2.0 ** -7
    return 1e-3 if cfg.family == "moe" else 1e-4


def update_share(cfg) -> float:
    """The share of a parameter update's elements that may lie more than
    ``lr / 100`` from the reference's after two steps (the rest agree to
    round-off; each within :func:`adam_step_tolerance`): 1%, a MoE's 35%
    (§C19: the reduced granite's one-device port step parts from JAX's
    in 25.7% of them, its bf16 dispatch's rounding carried through
    Adam's normalized steps)."""
    return 0.35 if cfg.family == "moe" else 0.01
