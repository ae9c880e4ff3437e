"""Step functions over the model facade (the JAX package's
``launch/steps.py``): the train step (grad accumulation, the int8
error-feedback compressed and checked gradient reduction, clipping, the
schedule and AdamW), the training state, and the serving steps (greedy
next token plus the step's fault metrics).

Over a data mesh (:func:`repro_torch.sharding.make_data_mesh`, one
process a rank) each step takes its rank's rows of the global batch
(:func:`repro_torch.data.pipeline.shard_batch`):

* :func:`make_train_step` with ``mesh``: the train CLI's step, JAX's
  jitted step on a ``(d, 1)`` mesh: each rank's gradients over its rows
  of every microbatch, mean-all-reduced in float32, then the one-device
  step (compression with ``group=None``) on every rank alike;
* :func:`make_train_step_deferred` (``make_train_step`` with
  ``deferred``): local accumulation with no collective, then one int8
  error-feedback :func:`checked_psum` over the data group a step, a
  residual per rank;
* :func:`make_train_step_zero1`: bf16 gradients reduce-scattered, AdamW
  on each rank's flat float32 block of the master weights and moments,
  one bf16 all-gather of the parameters.

On a mesh with a model axis (:func:`repro_torch.sharding.make_model_mesh`,
``(d, m)``): :func:`make_train_step` with such a ``mesh`` is JAX's jitted
step under ``train_rules`` (FSDP over ``data``, tensor parallelism over
``model``): the state is ``DTensor`` s placed by the rules
(:func:`init_train_state` with ``mesh``), each microbatch the
``DTensor`` of the batch shards' rows, and the one-device step body runs
on them under GSPMD's ways (:mod:`repro_torch.sharding.gspmd`).  The
deferred and ZeRO-1 steps stay data-only, as JAX's (ROADMAP §C15).
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.distributed as dist

from repro_torch.core.tree import (tree_leaves, tree_map,
                                   tree_unflatten_like)
from repro_torch.layers.common import Ctx
from repro_torch.layers.scan import ScanGraphs
from repro_torch.models.base import Model
from repro_torch.optim import (adamw_init, adamw_update,
                               clip_by_global_norm, is_trainable)
from repro_torch.optim.adamw import ieee_sqrt
from repro_torch.optim.schedule import warmup_cosine
from repro_torch.runtime.compression import (CompressionState,
                                             checked_psum, compress_grads,
                                             decompress_grads,
                                             init_compression, psum)


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
                g = torch.zeros_like(p, dtype=torch.float32
                                     if not is_trainable(p) else p.dtype)
            grads.append(g)
        metrics = {k: v.detach() if isinstance(v, torch.Tensor) else v
                   for k, v in metrics.items()}
        return (loss.detach(), metrics), tree_unflatten_like(params, grads)

    return grad_fn


def _const(value: float, device) -> torch.Tensor:
    return torch.tensor(float(value), dtype=torch.float32, device=device)


def accumulate(grad_fn, params, batch, accum: int):
    """((loss, metrics), grads) over ``accum`` microbatches of ``batch``
    run one after another: their gradients summed in float32 and divided
    by ``accum``, their losses and metrics averaged (float32), as JAX's
    scan does; one microbatch gives ``grad_fn``'s own."""
    if accum == 1:
        return grad_fn(params, batch)
    g_acc = tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                     params)
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
    return (loss, metrics), grads


def _pmean(x: torch.Tensor, mesh) -> torch.Tensor:
    """JAX's ``pmean``: the sum over the mesh's ranks over their count."""
    return psum(x, mesh.group) / _const(mesh.size, x.device).to(x.dtype)


def reduce_metrics(metrics: dict, mesh) -> dict:
    """A step's metrics over the data mesh, as JAX's ``_reduce_metrics``:
    integer counters summed, the rest averaged in float32 (each kind in
    one all-reduce)."""
    keys = sorted(metrics)
    vals = {k: torch.as_tensor(metrics[k]) for k in keys}
    ints = [k for k in keys if not vals[k].is_floating_point()]
    flts = [k for k in keys if k not in ints]
    out = {}
    if ints:
        s = psum(torch.stack([vals[k].reshape(()).to(torch.int32)
                              for k in ints]), mesh.group)
        out.update({k: s[i] for i, k in enumerate(ints)})
    if flts:
        m = _pmean(torch.stack([vals[k].reshape(()).to(torch.float32)
                                for k in flts]), mesh)
        out.update({k: m[i] for i, k in enumerate(flts)})
    return {k: out[k] for k in keys}


def make_train_step(model: Model, ctx: Ctx, *, accum: int = 1,
                    peak_lr: float = 3e-4, warmup: int = 100,
                    total_steps: int = 10000, max_grad_norm: float = 1.0,
                    compress: bool = False,
                    payload_hook: Optional[Callable] = None, mesh=None,
                    deferred: bool = False):
    """(state, batch) -> (new state, metrics).

    state = {"params", "opt", "step"} (+ ``"comm"``, the error-feedback
    residuals, with ``compress``; :func:`init_train_state`).  Batch
    leaves lead with the global batch; with ``accum`` > 1 the batch is
    split into microbatches run one after another, their gradients
    summed in float32 and divided by ``accum``, their losses and metrics
    averaged (float32), as JAX's scan does.

    ``compress=True`` routes the gradients through the int8 error-feedback
    compression and :func:`~repro_torch.runtime.compression.checked_psum`
    and reports the verifier in ``metrics["comm/errors"]`` for the loop's
    detect->act policy.  ``payload_hook(payload, state)``, where given,
    sees the compressed payload between the checksum encode and the
    reduction and returns the payload that is reduced: the transport seam
    a fault study corrupts.

    ``mesh`` (a data mesh, :func:`repro_torch.sharding.make_data_mesh`)
    says where the step's one gradient collective goes (a model mesh,
    :func:`repro_torch.sharding.make_model_mesh`, takes the module
    docstring's ``DTensor`` step instead):

    * ``deferred=False``, the train CLI's step: ``batch`` is this rank's
      rows of the global batch, laid out so each microbatch's rows are
      split over the ranks (``shard_batch(batch, BatchShard(rank, n,
      accum))``); the float gradients and the loss are mean-all-reduced
      and the metrics reduced over the mesh before compression, which
      then verifies alone (``group=None``), so every rank takes JAX's
      jitted step on the global batch (GSPMD over a ``(d, 1)`` mesh; a
      MoE's load-balance statistics are all-reduced over the mesh's
      group first, ``Ctx.data_group``, ROADMAP §C17);
    * ``deferred=True`` (:func:`make_train_step_deferred`): ``batch`` is
      this rank's contiguous rows; the gradients are accumulated with no
      collective, then the int8 payload goes through ``checked_psum``
      over the mesh's group (``state["comm"]`` this rank's residual), or
      without ``compress`` the float gradients are mean-all-reduced; the
      metrics are reduced at the end (:func:`reduce_metrics`).

    The step builds a new state and leaves ``state`` unchanged (the loop's
    recompute re-runs a step from it).  It owns the CUDA graphs its
    scans replay on the card (``ctx.scan_graphs``, made here): they are
    freed with the step.
    """
    from repro_torch.sharding import ModelMesh
    if isinstance(mesh, ModelMesh):
        if deferred:
            raise ValueError("the deferred step is data-only, as JAX's "
                             "(ROADMAP §C15): a data mesh, not a model one")
        return _make_model_mesh_step(
            model, ctx, mesh, accum=accum, peak_lr=peak_lr, warmup=warmup,
            total_steps=total_steps, max_grad_norm=max_grad_norm,
            compress=compress, payload_hook=payload_hook)
    ctx = ctx.replace(scan_graphs=ScanGraphs())
    if mesh is not None and not deferred:
        # the MoE's load-balance statistics over the global batch (§C17)
        ctx = ctx.replace(data_group=mesh.group)
    grad_fn = make_grad_fn(model, ctx)
    # the checked reduction's group and replica count: the mesh's for the
    # deferred step, else the verify-only one-device path
    group, n = (mesh.group, mesh.size) if deferred else (None, 1)

    def train_step(state, batch):
        params = state["params"]
        (loss, metrics), grads = accumulate(grad_fn, params, batch, accum)
        metrics = dict(metrics)
        if mesh is not None and not (deferred and compress):
            grads = tree_map(lambda g: _pmean(g.to(torch.float32), mesh),
                             grads)
        if mesh is not None and not deferred:
            loss = _pmean(loss, mesh)
            metrics = reduce_metrics(metrics, mesh)
        new_state = {}
        if compress:
            payload, new_comm = compress_grads(grads, state["comm"])
            del grads
            if payload_hook is not None:
                payload = payload_hook(payload, state)
            summed, scale_sum, comm_errs = checked_psum(payload, group)
            del payload
            grads = decompress_grads(summed, scale_sum, n)
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
        if deferred:
            metrics = reduce_metrics(metrics, mesh)
        return new_state, metrics

    return train_step


def batch_placements(mesh, ndim: int) -> list:
    """A batch leaf's placements on a model mesh: its rows split over
    every axis but ``model`` (JAX's ``batch`` rule), replicated over
    ``model``."""
    from torch.distributed.tensor import Replicate, Shard
    return [Replicate() if a == "model" else Shard(0) for a in mesh.axes] \
        if ndim else [Replicate()] * len(mesh.axes)


def place_batch(batch: dict, mesh) -> dict:
    """This batch shard's rows (``shard_batch(batch, BatchShard(
    mesh.batch_rank, mesh.n_batch))``) as the ``DTensor`` s of the global
    batch."""
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding.gspmd import _contiguous_stride
    out = {}
    for k, v in batch.items():
        shape = (v.shape[0] * mesh.n_batch,) + tuple(v.shape[1:])
        out[k] = DTensor.from_local(
            v.contiguous(), mesh.device_mesh, batch_placements(mesh, v.dim()),
            run_check=False, shape=torch.Size(shape),
            stride=_contiguous_stride(shape))
    return out


def whole_metrics(metrics: dict) -> dict:
    """A model-mesh step's metrics as plain tensors: a ``DTensor`` metric
    (a reduction over the sharded global batch) is already the global
    value, every rank alike."""
    from repro_torch.sharding.gspmd import is_dtensor
    return {k: v.full_tensor() if is_dtensor(v) else v
            for k, v in metrics.items()}


def _make_model_mesh_step(model: Model, ctx: Ctx, mesh, *, accum: int,
                          peak_lr: float, warmup: int, total_steps: int,
                          max_grad_norm: float, compress: bool,
                          payload_hook: Optional[Callable]):
    """:func:`make_train_step` on a model mesh (the module docstring):
    ``state`` from :func:`init_train_state` with ``mesh``; ``batch``
    this batch shard's rows, laid out so each microbatch's rows are split
    over the shards (``shard_batch(batch, BatchShard(mesh.batch_rank,
    mesh.n_batch, accum))``).  The gradients come back in their
    parameters' placements (JAX's ``out_shardings``); the metrics are the
    global batch's, every rank alike."""
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.sharding.gspmd import GspmdGather, GspmdMode
    from repro_torch.sharding.rules import train_rules
    ctx = ctx.replace(scan_graphs=ScanGraphs(),
                      rules=ctx.rules or train_rules(mesh.multi_pod))
    grad_fn = make_grad_fn(model, ctx)

    def placed_grad_fn(params, local):
        return grad_fn(params, place_batch(local, mesh))

    def train_step(state, batch):
        params = state["params"]
        # the layers' plain tensors (RoPE tables, masks, constants) take
        # part as replicated
        with implicit_replication(), GspmdGather(), GspmdMode():
            (loss, metrics), grads = accumulate(placed_grad_fn, params,
                                                batch, accum)
            grads = tree_map(lambda g, p: g.redistribute(
                p.device_mesh, p.placements) if g.placements != p.placements
                else g, grads, params)
            metrics = dict(metrics)
            new_state = {}
            if compress:
                payload, new_comm = compress_grads(grads, state["comm"])
                del grads
                if payload_hook is not None:
                    payload = payload_hook(payload, state)
                summed, scale_sum, comm_errs = checked_psum(payload, None)
                del payload
                grads = decompress_grads(summed, scale_sum, 1)
                del summed
                metrics["comm/errors"] = comm_errs
                new_state["comm"] = new_comm
            grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
            lr = warmup_cosine(state["step"], peak=peak_lr, warmup=warmup,
                               total=total_steps)
            new_params, new_opt = adamw_update(grads, state["opt"], params,
                                               lr)
            new_state.update(params=new_params, opt=new_opt,
                             step=state["step"] + 1)
            metrics.update({"grad_norm": gnorm, "lr": lr,
                            "loss_final": loss})
            return new_state, whole_metrics(metrics)

    return train_step


def make_train_step_deferred(model: Model, ctx: Ctx, mesh, *,
                             compress: bool = True, **kw):
    """The deferred-gradient-sync train step over the data mesh ``mesh``
    (JAX's ``make_train_step_deferred``, the data axis manual): local
    accumulation, then one gradient collective a step (with ``compress``
    the int8 error-feedback ``checked_psum`` over the data group, its
    residual this rank's own), the metrics reduced as JAX's
    ``_reduce_metrics`` does: integer counters summed over the ranks
    (``comm/errors`` too, so one corrupted reduction counts once a rank),
    the rest averaged.  Parameters are replicated.
    :func:`make_train_step` with ``deferred=True``; ``kw`` are its
    keywords."""
    return make_train_step(model, ctx, mesh=mesh, deferred=True,
                           compress=compress, **kw)


def ravel(tree, dtype) -> torch.Tensor:
    """The leaves of ``tree`` in ``dtype``, flattened and joined in the
    JAX flatten order (``jax.flatten_util.ravel_pytree``)."""
    return torch.cat([x.to(dtype).reshape(-1) for x in tree_leaves(tree)])


def unravel(flat: torch.Tensor, like):
    """:func:`ravel`'s inverse: ``like``'s structure, each leaf its run of
    ``flat`` in the leaf's shape and dtype."""
    out, i = [], 0
    for x in tree_leaves(like):
        out.append(flat[i:i + x.numel()].reshape(x.shape).to(x.dtype))
        i += x.numel()
    return tree_unflatten_like(like, out)


def make_train_step_zero1(model: Model, ctx: Ctx, mesh, *,
                          accum: int = 1, peak_lr: float = 3e-4,
                          warmup: int = 100, total_steps: int = 10000,
                          max_grad_norm: float = 1.0):
    """Pure data parallelism with ZeRO-1 over the data mesh ``mesh``
    (JAX's ``make_train_step_zero1``): bf16 parameters replicated; the
    float32 master weights and AdamW moments as flat blocks, one a rank
    (the flat layout sidesteps per-leaf divisibility).  A step: the bf16
    gradients raveled in the JAX leaf order, padded to a multiple of N
    and divided by N, one reduce-scatter, the global-norm clip from the
    blocks' sums of squares, AdamW on the block (JAX's constants), one
    bf16 all-gather of the updated blocks.

    state = {"params": bf16 tree, "opt": {"master", "m", "v": float32
    [D/N] blocks}, "step"} (:func:`init_zero1_state`); ``batch`` is this
    rank's contiguous rows.  -> (state, metrics)."""
    ctx = ctx.replace(scan_graphs=ScanGraphs())
    grad_fn = make_grad_fn(model, ctx)
    n = mesh.size
    b1, b2, eps, wd = 0.9, 0.95, 1e-8, 0.1

    def step(state, batch):
        params = state["params"]
        (loss, metrics), grads = accumulate(grad_fn, params, batch, accum)
        # raveled in the gradients' bf16: the float32 cast is taken on
        # the 1/N block only
        gflat = ravel(grads, torch.bfloat16)
        del grads
        pad = (-gflat.numel()) % n
        if pad:
            gflat = torch.cat([gflat, gflat.new_zeros(pad)])
        gflat = gflat / torch.tensor(n, dtype=torch.bfloat16,
                                     device=gflat.device)
        gshard = gflat.new_empty(gflat.numel() // n)
        dist.reduce_scatter_tensor(gshard, gflat, op=dist.ReduceOp.SUM,
                                   group=mesh.group)
        del gflat
        gshard = gshard.to(torch.float32)
        dev = gshard.device
        # the global-norm clip from the blocks' sums of squares
        gnorm = ieee_sqrt(psum(torch.sum(gshard * gshard), mesh.group))
        scale = torch.clamp(_const(max_grad_norm, dev)
                            / torch.clamp(gnorm, min=1e-9), max=1.0)
        gshard = gshard * scale
        lr = warmup_cosine(state["step"], peak=peak_lr, warmup=warmup,
                           total=total_steps)
        opt = state["opt"]
        cnt = (state["step"] + 1).to(torch.float32)
        m = b1 * opt["m"] + (1 - b1) * gshard
        v = b2 * opt["v"] + (1 - b2) * gshard * gshard
        mh = m / (1 - torch.pow(_const(b1, dev), cnt))
        vh = v / (1 - torch.pow(_const(b2, dev), cnt))
        master = opt["master"]
        master = master - lr * (mh / (ieee_sqrt(vh) + eps) + wd * master)
        # one collective for the parameters: the bf16 blocks gathered
        pflat = master.new_empty(master.numel() * n, dtype=torch.bfloat16)
        dist.all_gather_into_tensor(pflat, master.to(torch.bfloat16),
                                    group=mesh.group)
        if pad:
            pflat = pflat[:-pad]
        new_state = {"params": unravel(pflat, params),
                     "opt": {"master": master, "m": m, "v": v},
                     "step": state["step"] + 1}
        metrics = dict(metrics)
        metrics.update({"grad_norm": gnorm, "lr": lr,
                        "loss_final": _pmean(loss, mesh)})
        return new_state, reduce_metrics(metrics, mesh)

    return step


def _flat_size(params) -> int:
    return sum(x.numel() for x in tree_leaves(params))


def init_zero1_state(model: Model, seed: int, mesh, *, device="cuda"):
    """The ZeRO-1 state of :func:`make_train_step_zero1` on this rank:
    the float32 parameters from ``seed`` as the bf16 replicated tree and
    this rank's block of their flat float32 copy (the master weights),
    zero moments, step 0."""
    from repro_torch.runtime.elastic import flat_block
    params = model.init(seed, dtype=torch.float32, device=device)
    master = flat_block(ravel(params, torch.float32), mesh.size, mesh.rank)
    return {"params": tree_map(lambda p: p.to(torch.bfloat16), params),
            "opt": {"master": master, "m": torch.zeros_like(master),
                    "v": torch.zeros_like(master)},
            "step": torch.zeros((), dtype=torch.int32, device=master.device)}


def zero1_state_shapes(model: Model, n_shards: int):
    """(the ZeRO-1 state as ``meta`` tensors, its axes tree): JAX's
    ``zero1_state_sds``.  The flat vectors have their padded global
    length D + (-D mod N) and the axis :data:`~repro_torch.runtime.
    elastic.FLAT` (a rank holds a 1/N block); the bf16 parameters are
    replicated."""
    from repro_torch.runtime.elastic import FLAT
    params = model.init(0, dtype=torch.bfloat16, device="meta")
    d = _flat_size(params)
    d_pad = d + (-d) % n_shards
    flat = torch.empty((d_pad,), dtype=torch.float32, device="meta")
    state = {"params": params,
             "opt": {"master": flat, "m": flat, "v": flat},
             "step": torch.empty((), dtype=torch.int32, device="meta")}
    axes = {"params": tree_map(lambda p: (None,) * p.dim(), params),
            "opt": {"master": (FLAT,), "m": (FLAT,), "v": (FLAT,)},
            "step": ()}
    return state, axes


def zero1_full_state(state, mesh):
    """The whole ZeRO-1 state on every rank: each flat vector gathered
    from the ranks' blocks, its padding cut (the copy a checkpoint holds,
    which :func:`repro_torch.runtime.elastic.remesh_state` re-cuts for
    another world)."""
    d = _flat_size(state["params"])

    def gather(block):
        full = block.new_empty(block.numel() * mesh.size)
        dist.all_gather_into_tensor(full, block, group=mesh.group)
        return full[:d]

    return {"params": state["params"],
            "opt": {k: gather(v) for k, v in state["opt"].items()},
            "step": state["step"]}


def init_comm_state(params_shapes, n_data: int) -> CompressionState:
    """JAX's ``init_comm_state``: the error-feedback residuals of every
    rank, a leading data-axis dimension, as ``meta`` tensors (a rank
    holds its own row: ``init_compression`` of its parameters)."""
    return CompressionState(error=tree_map(
        lambda p: torch.empty((n_data,) + tuple(p.shape),
                              dtype=torch.float32, device="meta"),
        params_shapes))


def init_train_state(model: Model, seed: int, *, dtype=torch.float32,
                     compress: bool = False, device="cuda", mesh=None):
    """The concrete training state: float parameters from ``seed``, zero
    AdamW moments, step 0 (and with ``compress`` the zero error-feedback
    residuals, as :func:`make_train_step` ``(compress=True)`` needs).
    With ``mesh`` (a model mesh) the parameters are this rank's blocks
    of the same ones, placed by ``train_rules`` as JAX's
    ``in_shardings`` place them, and the moments and residuals follow
    them; the step counter is replicated."""
    params = model.init(seed, dtype=dtype, device=device)
    if mesh is not None:
        from repro_torch.sharding import distribute_tree
        from repro_torch.sharding.logical import param_axes
        from repro_torch.sharding.rules import train_rules
        params = distribute_tree(params, param_axes(params),
                                 train_rules(mesh.multi_pod),
                                 mesh.device_mesh)
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
