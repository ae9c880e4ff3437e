"""What each rank of the port's tensor-parallel tests runs
(``tests/test_torch_train_tp.py``): functions
:func:`repro_torch.sharding.launch` spawns by name, so this module
imports no JAX.  Rank 0 returns numpy results; the test process holds
them against JAX's steps and the port's one-device step.

The inputs (each arch's reduced parameters from the port's init, the
global batches, the learning rate) come from ``inputs.npz`` in the
directory the test hands over.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch, reduce_cfg
from repro_torch.core.tree import tree_leaves, tree_unflatten_like
from repro_torch.data.pipeline import BatchShard, shard_batch
from repro_torch.launch import steps as tsteps
from repro_torch.layers.common import Ctx
from repro_torch.models.base import build_model
from repro_torch.protect import default_plan
from repro_torch.sharding import (distribute, full_tree, make_data_mesh,
                                  make_model_mesh)
from repro_torch.sharding.rules import train_rules

ARCHS = ("llama3.2-1b", "granite-moe-3b-a800m", "mistral-large-123b",
         "llama4-scout-17b-a16e")
#: global batch rows, tokens a row, steps, learning rate
BATCH, SEQ, STEPS, LR = 8, 16, 2, 1e-4
#: (arch, mesh) of each step JAX takes too: every arch on (2, 2), the
#: dense Llama on (1, 2), granite's data mesh (2, 1) (§C17)
TP_CASES = [(a, (2, 2)) for a in ARCHS] + [("llama3.2-1b", (1, 2))]
DATA_CASE = ("granite-moe-3b-a800m", (2, 1))


def model_and_ctx(arch):
    cfg = reduce_cfg(get_arch(arch))
    return build_model(cfg, max_pos=64), Ctx(
        rules=train_rules(), plan=default_plan(), quant=False,
        compute_dtype=torch.float32)


def make_inputs(path: str) -> dict:
    """Each arch's port parameters (seed 3) and the global batches, in
    ``path`` (``inputs.npz``); -> the arrays."""
    inputs = {"lr": np.float32(LR), "batch": BATCH, "seq": SEQ,
              "steps": STEPS}
    rng = np.random.default_rng(7)
    vocab = reduce_cfg(get_arch(ARCHS[0])).vocab
    for t in range(STEPS):
        toks = rng.integers(0, vocab, (BATCH, SEQ + 1))
        inputs[f"tokens{t}"] = toks[:, :-1].astype(np.int32)
        inputs[f"labels{t}"] = toks[:, 1:].astype(np.int32)
    for arch in ARCHS:
        model, _ = model_and_ctx(arch)
        for i, x in enumerate(tree_leaves(model.init(3, device="cpu"))):
            inputs[f"{arch}/p{i}"] = x.numpy()
    np.savez(path, **inputs)
    return inputs


def _params(z, arch):
    model, _ = model_and_ctx(arch)
    like = model.init(0, device="meta")
    return tree_unflatten_like(like, [
        torch.from_numpy(z[f"{arch}/p{i}"].copy())
        for i in range(len(tree_leaves(like)))])


def _batch(z, t):
    return {k: torch.from_numpy(z[f"{k}{t}"].copy())
            for k in ("tokens", "labels")}


def _kw():
    return dict(accum=1, peak_lr=LR, warmup=0, total_steps=10)


def _state(model, params, mesh):
    """The one-device state from ``params``, placed on ``mesh`` (as
    :func:`init_train_state` with ``mesh`` places the seeded one)."""
    state = tsteps.init_train_state(model, 0, device="cpu", mesh=mesh)
    if mesh is None:
        state["params"] = params
        return state
    state["params"] = tree_unflatten_like(params, [
        distribute(p, d.device_mesh, d.placements) for p, d in
        zip(tree_leaves(params), tree_leaves(state["params"]))])
    return state


def _metrics(m):
    return {k: float(v) for k, v in m.items()}


def model_mesh_steps(z, arch, shape):
    """2 steps of the model-mesh step over the world's first ranks; rank
    0's whole parameters and metrics (None on a rank outside)."""
    model, ctx = model_and_ctx(arch)
    mesh = make_model_mesh(shape, ranks=range(shape[0] * shape[1]))
    if mesh.device_mesh.get_coordinate() is None:
        return None
    step = tsteps.make_train_step(model, ctx, mesh=mesh, **_kw())
    state = _state(model, _params(z, arch), mesh)
    mets = []
    for t in range(STEPS):
        local = shard_batch(_batch(z, t), BatchShard(mesh.batch_rank,
                                                     mesh.n_batch))
        state, m = step(state, local)
        mets.append(_metrics(m))
    params = full_tree(state["params"])
    return {"params": [x.numpy().copy() for x in tree_leaves(params)],
            "metrics": mets}


def data_mesh_steps(z, arch, n):
    """2 steps of the train CLI's data-mesh step over ``n`` ranks."""
    model, ctx = model_and_ctx(arch)
    mesh = make_data_mesh(n)
    if not mesh.member:
        return None
    step = tsteps.make_train_step(model, ctx, mesh=mesh, **_kw())
    state = _state(model, _params(z, arch), None)
    mets = []
    for t in range(STEPS):
        local = shard_batch(_batch(z, t), BatchShard(mesh.rank, mesh.size))
        state, m = step(state, local)
        mets.append(_metrics(m))
    return {"params": [x.numpy().copy()
                       for x in tree_leaves(state["params"])],
            "metrics": mets}


def one_device_steps(z, arch):
    model, ctx = model_and_ctx(arch)
    step = tsteps.make_train_step(model, ctx.replace(rules=None), **_kw())
    state = _state(model, _params(z, arch), None)
    mets = []
    for t in range(STEPS):
        state, m = step(state, _batch(z, t))
        mets.append(_metrics(m))
    return {"params": [x.numpy().copy()
                       for x in tree_leaves(state["params"])],
            "metrics": mets}


def checkpointed(z, ckpt_dir):
    """The loop on the (2, 2) mesh: 2 steps, saved by rank 0 (each leaf
    gathered), then restored into a new placed state and re-cut: every
    rank's blocks equal to its trained ones."""
    from repro_torch.runtime import LoopConfig, TrainLoop
    arch = ARCHS[0]
    model, ctx = model_and_ctx(arch)
    mesh = make_model_mesh((2, 2))
    step = tsteps.make_train_step(model, ctx, mesh=mesh, **_kw())

    class Data:
        def batch_at(self, t):
            return {k: v.numpy() for k, v in _batch(z, t % STEPS).items()}

    loop = TrainLoop(step, Data(), cfg=LoopConfig(
        ckpt_dir=ckpt_dir, save_every=1, fault_policy="recompute"),
        shardings=BatchShard(mesh.batch_rank, mesh.n_batch),
        group=dist.group.WORLD)
    final, _ = loop.run(_state(model, _params(z, arch), mesh), STEPS,
                        resume=False)
    fresh = _state(model, _params(z, arch), mesh)
    back, at = loop.ckpt.restore_latest(fresh)
    same = all(a.placements == b.placements and
               torch.equal(a.to_local(), b.to_local())
               for a, b in zip(tree_leaves(final["params"]) +
                               tree_leaves(final["opt"]["m"]),
                               tree_leaves(back["params"]) +
                               tree_leaves(back["opt"]["m"])))
    ok = torch.tensor([int(same)])
    dist.all_reduce(ok)
    files = sorted(os.listdir(os.path.join(ckpt_dir, f"step_{STEPS:09d}")))
    sharded = sum(a.to_local().numel() < a.numel()
                  for a in tree_leaves(final["params"]))
    return {"files": files, "restored_step": at,
            "ranks_equal": int(ok), "sharded_leaves": sharded,
            "stats": dict(loop.stats)}


def tp_cases(world, d):
    """Every multi-rank case of ``tests/test_torch_train_tp.py`` in one
    world of 4 ranks."""
    import time
    z = np.load(os.path.join(d, "inputs.npz"))
    out = {"tp": {}, "timing": {}}
    for arch, shape in TP_CASES:
        t0 = time.time()
        out["tp"][arch, shape] = model_mesh_steps(z, arch, shape)
        out["timing"][arch, shape] = time.time() - t0
    arch, (n, _) = DATA_CASE
    out["data"] = data_mesh_steps(z, arch, n)
    out["one_by_one"] = model_mesh_steps(z, ARCHS[0], (1, 1))
    out["ckpt"] = checkpointed(z, os.path.join(d, "ckpt"))
    out["branches"] = branch_cases(world)
    if world.rank == 0:
        out["one_device"] = {a: one_device_steps(z, a) for a in ARCHS}
    return out


# ------------------------------ the shared branches ------------------------

def _err(got, want) -> float:
    if hasattr(got, "full_tensor"):
        got = got.full_tensor()
    return float((got.detach().double() - want.double()).abs().max())


def branch_cases(world):
    """Each branch of :func:`repro_torch.sharding.gspmd.gspmd_hook` (and
    the gather and lookup above autograd) on a (2, 2) mesh of real
    ranks, against the plain op on the whole tensors: ``{branch: (max
    error, the plain result's largest magnitude)}``."""
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.base import cross_entropy
    from repro_torch.sharding.gspmd import (GspmdGather, GspmdMode,
                                            vocab_lookup)
    mesh = make_model_mesh((2, 2)).device_mesh
    gen = torch.Generator().manual_seed(11)

    def rand(*shape):
        return torch.randn(shape, generator=gen)

    def put(t, *pl):
        return distribute_tensor(t, mesh, list(pl))

    out = {}
    R = Replicate()
    with implicit_replication(), GspmdMode():
        # a collective of torch.distributed on a DTensor: each rank's
        # local shard reduced over the group
        x = rand(8, 4)
        dx = put(x, Shard(0), R)
        dist.all_reduce(dx, group=mesh.get_group("model"))
        out["c10d"] = (_err(dx, 2 * x), float(x.abs().max()))
        # a product whose operand is a partial sum
        a, b, c = rand(6, 8), rand(8, 5), rand(5, 3)
        ab = put(a, R, Shard(1)) @ put(b, R, Shard(0))
        out["partial_product"] = (_err(ab @ put(c, R, R), a @ b @ c),
                                  float((a @ b @ c).abs().max()))
        # an elementwise op with no DTensor strategy
        out["pointwise"] = (_err(_twice()(put(x, Shard(0), R)), 2 * x),
                            float(x.abs().max()))
        # a buffer shaped like a sharded tensor
        buf = put(x, Shard(0), Shard(1)).new_full((8, 4), 3.0)
        out["factory"] = (_err(buf, torch.full((8, 4), 3.0))
                          + float(buf.placements != (Shard(0), Shard(1))),
                          3.0)
        # a gather and a scatter along sharded dimensions
        table = rand(10, 4)
        ids = torch.tensor([[9, 0, 4, 5], [1, 7, 3, 2]])
        got = put(table, R, Shard(0))[put(ids, Shard(0), R)]
        out["index_gather"] = (_err(got, table[ids]),
                               float(table.abs().max()))
        vals = rand(2, 4, 4)
        acc = torch.ops.aten.index_put(put(table, R, Shard(0)),
                                       [put(ids, R, R)], put(vals, R, R),
                                       True)
        out["index_put_add"] = (_err(acc, torch.ops.aten.index_put(
            table, [ids], vals, True)), float(table.abs().max()))
        cache = rand(4, 2, 8, 3)
        rows, bi = rand(4, 2, 3), torch.arange(4)
        pos = torch.tensor([7, 0, 3, 4])
        want = cache.clone()
        want[bi, :, pos] = rows
        dc = put(cache, Shard(0), Shard(2))
        dc = torch.ops.aten.index_put(dc, [put(bi, R, R), None,
                                           put(pos, R, R)], put(rows, R, R))
        out["index_put_set"] = (_err(dc, want), float(cache.abs().max()))
        # reductions over a sharded dimension
        y = rand(4, 10)
        out["argmax"] = (_err(torch.argmax(put(y, R, Shard(1)), dim=1),
                              torch.argmax(y, dim=1)), 1.0)
        out["logsumexp"] = (_err(torch.logsumexp(put(y, R, Shard(1)),
                                                 dim=1),
                                 torch.logsumexp(y, dim=1)),
                            float(torch.logsumexp(y, dim=1).abs().max()))
        # a view of DTensor's masked vocab-parallel lookup
        emb = torch.nn.functional.embedding(put(ids, R, R),
                                            put(table, R, Shard(0)))
        out["masked_view"] = (_err(emb.reshape(8, 4),
                                   table[ids].reshape(8, 4)),
                              float(table.abs().max()))
        # a reshape DTensor refuses, re-tiled
        w = rand(6, 4)
        out["retile"] = (_err(put(w, R, Shard(0)).reshape(4, 6),
                              w.reshape(4, 6)), float(w.abs().max()))
    # DTensor's functional collectives on gloo, run as torch.distributed's
    # (an all-gather, a reduce-scatter and an all-reduce, counted)
    from torch.distributed.tensor import DTensor, Partial

    from repro_torch.sharding import gspmd
    ran, real = [], gspmd._gloo_collective

    def counted(func, *a):
        out = real(func, *a)
        if out is not NotImplemented and "wait" not in str(func):
            ran.append(func)
        return out
    gspmd._gloo_collective = counted
    try:
        with GspmdMode():
            parts = [put(x, Shard(0), Shard(1)).redistribute(mesh, [R, R]),
                     DTensor.from_local(x, mesh, [Partial(), R]).redistribute(
                         mesh, [Shard(0), R]),
                     DTensor.from_local(x, mesh, [R, Partial()]).redistribute(
                         mesh, [R, R])]
    finally:
        gspmd._gloo_collective = real
    out["gloo_collectives"] = (
        _err(parts[0], x) + _err(parts[1], 2 * x) + _err(parts[2], 2 * x)
        + float(len(ran) < 3), float(x.abs().max()))
    # above autograd: the cross-entropy's gather and the token lookup,
    # values and gradients
    logits = rand(4, 3, 12)
    labels = torch.randint(0, 12, (4, 3), generator=gen)
    want_l = logits.clone().requires_grad_(True)
    cross_entropy(want_l, labels, 12).backward()
    got_l = put(logits, Shard(0), Shard(2)).requires_grad_(True)
    with implicit_replication(), GspmdGather(), GspmdMode():
        loss = cross_entropy(got_l, put(labels, Shard(0), R), 12)
        loss.backward()
    out["gather"] = (_err(loss, cross_entropy(logits, labels, 12))
                     + _err(got_l.grad, want_l.grad),
                     float(want_l.grad.abs().max()))
    want_t = table.clone().requires_grad_(True)
    (want_t[ids] * vals).sum().backward()
    got_t = put(table, Shard(1), Shard(0)).requires_grad_(True)
    with implicit_replication(), GspmdMode():
        r = vocab_lookup(got_t, put(ids, Shard(0), R))
        (r * put(vals, Shard(0), R)).sum().backward()
    out["vocab_lookup"] = (_err(r, table[ids]) + _err(got_t.grad,
                                                      want_t.grad),
                           float(want_t.grad.abs().max()))
    return out


def _twice():
    """A pointwise op DTensor has no strategy for (a library of this
    module's own, defined once a process)."""
    ns = "tp_ranks_test"
    if not hasattr(torch.ops, ns) or not hasattr(getattr(torch.ops, ns),
                                                 "twice"):
        lib = torch.library.Library(ns, "DEF")
        lib.define("twice(Tensor x) -> Tensor", tags=(torch.Tag.pointwise,))
        lib.impl("twice", lambda x: 2 * x, "CPU")
        lib.impl("twice", lambda x: torch.empty_like(x), "Meta")
        _twice.lib = lib
    return torch.ops.tp_ranks_test.twice.default
