"""Step functions over the model facade (the JAX package's
``launch/steps.py``): the train step (grad accumulation, the int8
error-feedback compressed and checked gradient reduction, clipping, the
schedule and AdamW), the training state, and the serving steps (greedy
next token plus the step's fault metrics).  The deferred-sync and ZeRO-1
train steps shard over a mesh and wait for ROADMAP A8."""
from __future__ import annotations

from typing import Callable, Optional

import torch

from repro_torch.core.tree import (tree_leaves, tree_map,
                                   tree_unflatten_like)
from repro_torch.layers.common import Ctx
from repro_torch.layers.scan import ScanGraphs
from repro_torch.models.base import Model
from repro_torch.optim import (adamw_init, adamw_update,
                               clip_by_global_norm, is_trainable)
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.compression import (checked_psum, compress_grads,
                                             decompress_grads,
                                             init_compression)


def make_grad_fn(model: Model, ctx: Ctx):
    """(params, batch) -> ((loss, metrics), grads): the loss and its
    gradient with respect to every trainable leaf (``jax.value_and_grad``
    of ``model.loss`` with its metrics as aux).  The parameters are not
    changed; a frozen leaf's gradient is float32 zeros.  Loss and metrics
    come back detached."""

    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda p: p.detach().requires_grad_(True)
                            if is_trainable(p) else p, params)
            loss, (metrics, _rep) = model.loss(live, batch, ctx)
            leaves = tree_leaves(live)
            wrt = [p for p in leaves if p.requires_grad]
            got = iter(torch.autograd.grad(loss, wrt, allow_unused=True))
        grads = []
        for p in leaves:
            g = next(got) if p.requires_grad else None
            if g is None:
                g = torch.zeros(p.shape, dtype=torch.float32
                                if not is_trainable(p) else p.dtype,
                                device=p.device)
            grads.append(g)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return (loss.detach(), metrics), tree_unflatten_like(params, grads)

    return grad_fn


def _const(value: float, device) -> torch.Tensor:
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def make_train_step(model: Model, ctx: Ctx, *, accum: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, max_grad_norm: float = 1.0,
                    compress: bool = False, group=None,
                    n_replicas: int = 1,
                    payload_hook: Optional[Callable] = None):
    """(state, batch) -> (new state, metrics).

    state = {"params", "opt", "step"} (+ ``"comm"``, the error-feedback
    residuals, with ``compress``; :func:`init_train_state`).  Batch
    leaves lead with the global batch; with ``accum`` > 1 the batch is
    split into microbatches run one after another, their gradients
    summed in float32 and divided by ``accum``, their losses and metrics
    averaged (float32), as JAX's scan does.

    ``compress=True`` routes the gradients through the int8 error-feedback
    compression and :func:`~repro_torch.runtime.compression.checked_psum`
    (``group=None``: the single-device verify-only path; a process group
    and its size otherwise) and reports the verifier in
    ``metrics["comm/errors"]`` for the loop's detect->act policy.
    ``payload_hook(payload, state)``, where given, sees the compressed
    payload between the checksum encode and the reduction and returns the
    payload that is reduced: the transport seam a fault study corrupts.

    The step builds a new state and leaves ``state`` unchanged (the loop's
    recompute re-runs a step from it).  It owns the CUDA graphs its
    scans replay on the card (``ctx.scan_graphs``, made here): they are
    freed with the step.
    """
    ctx = ctx.replace(scan_graphs=ScanGraphs())
    grad_fn = make_grad_fn(model, ctx)

    def train_step(state, batch):
        params = state["params"]
        if accum == 1:
            (loss, metrics), grads = grad_fn(params, batch)
        else:
            g_acc = tree_map(lambda p: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device), params)
            losses, mets = [], []
            for i in range(accum):
                mb = {k: v.reshape((accum, v.shape[0] // accum)
                                   + tuple(v.shape[1:]))[i]
                      for k, v in batch.items()}
                (l_i, m_i), g = grad_fn(params, mb)
                # the sum is this step's own buffer: added to in place
                tree_map(lambda a, b: a.add_(b.to(torch.float32)), g_acc, g)
                del g
                losses.append(l_i)
                mets.append(m_i)
            n = _const(accum, losses[0].device)
            grads = tree_map(lambda g: g.div_(n), g_acc)
            del g_acc
            loss = torch.mean(torch.stack(losses))
            dev = loss.device
            metrics = {k: torch.mean(torch.stack([
                torch.as_tensor(m[k], device=dev).to(torch.float32)
                for m in mets])) for k in mets[0]}

        metrics = dict(metrics)
        new_state = {}
        if compress:
            payload, new_comm = compress_grads(grads, state["comm"])
            del grads
            if payload_hook is not None:
                payload = payload_hook(payload, state)
            summed, scale_sum, comm_errs = checked_psum(payload, group)
            del payload
            grads = decompress_grads(summed, scale_sum, n_replicas)
            del summed
            metrics["comm/errors"] = comm_errs
            new_state["comm"] = new_comm

        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        lr = warmup_cosine(state["step"], peak=peak_lr, warmup=warmup,
                           total=total_steps)
        new_params, new_opt = adamw_update(grads, state["opt"], params, lr)
        new_state.update(params=new_params, opt=new_opt,
                         step=state["step"] + 1)
        metrics.update({"grad_norm": gnorm, "lr": lr, "loss_final": loss})
        return new_state, metrics

    return train_step


def init_train_state(model: Model, seed: int, *, dtype=torch.float32,
                     compress: bool = False, device="cuda"):
    """The concrete training state: float parameters from ``seed``, zero
    AdamW moments, step 0 (and with ``compress`` the zero error-feedback
    residuals, as :func:`make_train_step` ``(compress=True)`` needs)."""
    params = model.init(seed, dtype=dtype, device=device)
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32,
                                 device=tree_leaves(params)[0].device)}
    if compress:
        state["comm"] = init_compression(params)
    return state


def train_state_shapes(model: Model, *, dtype=torch.float32,
                       compress: bool = False):
    """The training state as ``meta`` tensors: its shapes and dtypes with
    no storage (JAX's ``train_state_lp`` without the logical axes), so a
    full-width state is reckoned without memory."""
    return init_train_state(model, 0, dtype=dtype, compress=compress,
                            device="meta")


def state_bytes(state) -> int:
    """The bytes of a state tree's leaves (a meta tree's included)."""
    return sum(t.numel() * t.element_size() for t in tree_leaves(state))


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
