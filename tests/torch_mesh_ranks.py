"""What each rank of the port's data-mesh tests runs
(``tests/test_torch_train_mesh.py``, ``tests/test_torch_sharding.py``):
functions :func:`repro_torch.sharding.launch` spawns by name, so this
module imports no JAX.  Rank 0 returns numpy results; the test process
holds them against JAX's and the port's one-device steps.

The inputs (the reduced Llama-3.2-1B's parameters from the port's init,
the global batches, the learning rate) come from ``inputs.npz`` in the
directory the test hands over.
"""
import os

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_arch, reduce_cfg
from repro_torch.core.tree import tree_leaves, tree_map, tree_unflatten_like
from repro_torch.data.pipeline import BatchShard, shard_batch
from repro_torch.launch import steps as tsteps
from repro_torch.layers.common import Ctx
from repro_torch.models.base import build_model
from repro_torch.optim import adamw_init
from repro_torch.protect import default_plan
from repro_torch.runtime.compression import init_compression
from repro_torch.sharding import make_data_mesh

ARCH = "llama3.2-1b"
#: global batch rows, tokens a row, data shards, microbatches, steps
BATCH, SEQ, SHARDS, ACCUM, STEPS = 8, 16, 4, 2, 2


def model_and_ctx():
    cfg = reduce_cfg(get_arch(ARCH))
    return build_model(cfg, max_pos=64), Ctx(
        plan=default_plan(), quant=False, compute_dtype=torch.float32)


def load_inputs(d):
    z = np.load(os.path.join(d, "inputs.npz"))
    model, _ = model_and_ctx()
    like = model.init(0, device="meta")
    params = tree_unflatten_like(like, [
        torch.from_numpy(z[f"p{i}"].copy())
        for i in range(len(tree_leaves(like)))])
    batches = [{"tokens": z[f"tokens{t}"], "labels": z[f"labels{t}"]}
               for t in range(STEPS)]
    return params, batches, float(z["lr"])


def _tensors(batch):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def _np(tree):
    return [x.detach().to(torch.float32).numpy().copy()
            if x.dtype == torch.bfloat16 else x.detach().numpy().copy()
            for x in tree_leaves(tree)]


def _gather_rows(x, mesh):
    """``x`` of every rank of the mesh, stacked (rank order)."""
    out = [torch.empty_like(x) for _ in range(mesh.size)]
    dist.all_gather(out, x.contiguous(), group=mesh.group)
    return torch.stack(out)


def _kw(lr):
    return dict(accum=ACCUM, peak_lr=lr, warmup=0, total_steps=10)


def deferred(world, params, batches, lr, mesh):
    """JAX's deferred step: 2 steps with compression; the summed int32
    payload a step (seen through the transport seam), the metrics, the
    final parameters and every rank's residual."""
    model, ctx = model_and_ctx()
    sums = []

    def seen(payload, state):
        q = [x.to(torch.int32) for x in tree_leaves(payload["q"])]
        for x in q:
            dist.all_reduce(x, group=mesh.group)
        sums.append([x.numpy().copy() for x in q])
        return payload

    step = tsteps.make_train_step_deferred(model, ctx, mesh,
                                           payload_hook=seen, **_kw(lr))
    state = {"params": params, "opt": adamw_init(params),
             "step": torch.zeros((), dtype=torch.int32),
             "comm": init_compression(params)}
    mets = []
    for t in range(STEPS):
        local = _tensors(shard_batch(batches[t], BatchShard(mesh.rank,
                                                            mesh.size)))
        state, m = step(state, local)
        mets.append({k: float(v) for k, v in m.items()})
    resid = [_gather_rows(e, mesh).numpy()
             for e in tree_leaves(state["comm"].error)]
    return {"sums": sums, "metrics": mets, "params": _np(state["params"]),
            "resid": resid}


def zero1(world, params, batches, lr, mesh):
    """JAX's ZeRO-1 step: 2 steps; the bf16 parameters and the gathered
    float32 master weights and moments."""
    model, ctx = model_and_ctx()
    step = tsteps.make_train_step_zero1(model, ctx, mesh, **_kw(lr))
    from repro_torch.runtime.elastic import flat_block
    master = flat_block(tsteps.ravel(params, torch.float32), mesh.size,
                        mesh.rank)
    state = {"params": tree_map(lambda p: p.to(torch.bfloat16), params),
             "opt": {"master": master, "m": torch.zeros_like(master),
                     "v": torch.zeros_like(master)},
             "step": torch.zeros((), dtype=torch.int32)}
    mets = []
    for t in range(STEPS):
        local = _tensors(shard_batch(batches[t], BatchShard(mesh.rank,
                                                            mesh.size)))
        state, m = step(state, local)
        mets.append({k: float(v) for k, v in m.items()})
    full = tsteps.zero1_full_state(state, mesh)
    return {"metrics": mets, "params": _np(state["params"]),
            "opt": {k: v.numpy().copy() for k, v in full["opt"].items()},
            "state": state, "full": full}


def mesh_step(world, params, batches, lr, mesh, compress=True):
    """The train CLI's mesh step over ``mesh``: 2 steps; the final
    parameters and the metrics."""
    model, ctx = model_and_ctx()
    step = tsteps.make_train_step(model, ctx, compress=compress, mesh=mesh,
                                  **_kw(lr))
    state = tsteps.init_train_state(model, 0, compress=compress,
                                    device="cpu")
    state["params"] = params
    mets = []
    for t in range(STEPS):
        local = _tensors(shard_batch(
            batches[t], BatchShard(mesh.rank, mesh.size, ACCUM)))
        state, m = step(state, local)
        mets.append({k: float(v) for k, v in m.items()})
    return {"params": _np(state["params"]), "metrics": mets}


def one_device(params, batches, lr, compress=True):
    """The port's one-device step on the global batch, 2 steps."""
    model, ctx = model_and_ctx()
    step = tsteps.make_train_step(model, ctx, compress=compress, **_kw(lr))
    state = tsteps.init_train_state(model, 0, compress=compress,
                                    device="cpu")
    state["params"] = params
    mets = []
    for t in range(STEPS):
        state, m = step(state, _tensors(batches[t]))
        mets.append({k: float(v) for k, v in m.items()})
    return {"params": _np(state["params"]), "metrics": mets}


def elastic(world, z, mesh3):
    """ZeRO-1's state gathered on 4 ranks, saved by rank 0, restored
    onto 3 of them and re-cut (:func:`remesh_state`): each block equal to
    its cut of the full copy, and the gathered state equal to it."""
    from repro_torch.checkpoint.ckpt import load_checkpoint, save_checkpoint
    from repro_torch.runtime.elastic import flat_block, remesh_state
    from repro_torch.sharding import serve_rules
    full = z["full"]
    ckpt = os.path.join(os.environ["REPRO_MESH_TMP"], "zero1")
    if world.rank == 0:
        save_checkpoint(ckpt, 2, full, shard=0)
    dist.barrier()
    out = {}
    if mesh3.member:
        model, _ = model_and_ctx()
        _, axes = tsteps.zero1_state_shapes(model, mesh3.size)
        back = load_checkpoint(ckpt, 2, full, shard=0)
        state = remesh_state(back, axes, serve_rules(), mesh3)
        cuts = all(torch.equal(state["opt"][k],
                               flat_block(full["opt"][k], 3, mesh3.rank))
                   for k in ("master", "m", "v"))
        again = tsteps.zero1_full_state(state, mesh3)
        out = {"cuts_equal": cuts,
               "round_trip": all(torch.equal(again["opt"][k],
                                             full["opt"][k])
                                 for k in ("master", "m", "v")),
               "block": state["opt"]["master"].numel()}
    return out


def checkpointed(world, params, batches, lr, mesh, ckpt_dir):
    """The CLI's loop over the mesh: 2 steps saved by rank 0 alone (the
    state is replicated), then every rank restores rank 0's copy."""
    from repro_torch.runtime import LoopConfig, TrainLoop
    model, ctx = model_and_ctx()
    step = tsteps.make_train_step(model, ctx, compress=True, mesh=mesh,
                                  **_kw(lr))

    class Data:
        def batch_at(self, t):
            return batches[t % STEPS]

    state = tsteps.init_train_state(model, 0, compress=True, device="cpu")
    state["params"] = params
    loop = TrainLoop(step, Data(), cfg=LoopConfig(
        ckpt_dir=ckpt_dir, save_every=1, fault_policy="recompute"),
        shardings=BatchShard(mesh.rank, mesh.size, ACCUM), group=mesh.group)
    final, _ = loop.run(state, STEPS, resume=False)
    back, at = loop.ckpt.restore_latest(final)     # after rank 0's write
    files = sorted(os.listdir(os.path.join(ckpt_dir, f"step_{STEPS:09d}")))
    same = all(torch.equal(a, b) for a, b in
               zip(tree_leaves(final), tree_leaves(back)))
    return {"files": files, "restored_step": at, "restored_equal": same,
            "stats": dict(loop.stats)}


def train_mesh_cases(world, d):
    """Every multi-rank case of ``tests/test_torch_train_mesh.py`` in one
    world of 4 ranks."""
    os.environ["REPRO_MESH_TMP"] = d
    params, batches, lr = load_inputs(d)
    mesh4 = make_data_mesh(SHARDS)
    mesh2 = make_data_mesh(2)
    mesh3 = make_data_mesh(3)
    out = {"deferred": deferred(world, params, batches, lr, mesh4)}
    z = zero1(world, params, batches, lr, mesh4)
    out["elastic"] = elastic(world, z, mesh3)
    out["zero1"] = {k: z[k] for k in ("metrics", "params", "opt")}
    out["mesh4"] = mesh_step(world, params, batches, lr, mesh4)
    out["mesh2"] = mesh_step(world, params, batches, lr, mesh2) \
        if mesh2.member else None
    out["ckpt"] = checkpointed(world, params, batches, lr, mesh4,
                               os.path.join(d, "loop_ckpt"))
    if world.rank == 0:
        out["one_device"] = one_device(params, batches, lr)
    return out


def sharding_cases(world):
    """``tests/test_torch_sharding.py``'s cases on 4 ranks: the data mesh,
    the host mesh, the plan's mesh, and each rank's blocks of a state as
    :func:`remesh_state` cuts them against ``distribute_tensor``'s local
    shards under the same placements."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.runtime.elastic import (make_mesh_from_plan,
                                             plan_remesh, remesh_state)
    from repro_torch.sharding import (placements_of, serve_rules,
                                      specs_of, train_rules)
    out = {}
    mesh = make_data_mesh(4)
    half = make_data_mesh(2, ranks=(2, 3))
    x = torch.full((3,), float(world.rank))
    dist.all_reduce(x, group=mesh.group)
    out["data_mesh"] = (mesh.size, mesh.rank, x.tolist(),
                        tuple(mesh.device_mesh.mesh_dim_names))
    out["half"] = (half.member, half.rank if half.member else None)
    if half.member:
        y = torch.ones(())
        dist.all_reduce(y, group=half.group)
        assert float(y) == 2.0
    host = make_host_mesh((2, 2))
    out["host"] = (tuple(host.shape), tuple(host.mesh_dim_names),
                   tuple(host.get_coordinate()))
    plan = plan_remesh(4, model_parallel=2)
    pm = make_mesh_from_plan(plan)
    out["plan_mesh"] = (tuple(pm.shape), tuple(pm.mesh_dim_names))

    # a state's blocks on a (4, 1) mesh: serve rules replicate it, train
    # rules cut the embed dimension over data (FSDP) as DTensor does
    model, _ = model_and_ctx()
    params = model.init(0, device="cpu")
    axes = model.param_axes()
    dm = make_host_mesh((4, 1))
    rep = remesh_state(params, axes, serve_rules(), dm)
    out["serve_replicated"] = all(
        torch.equal(a, b) for a, b in zip(tree_leaves(rep),
                                          tree_leaves(params)))
    cut = remesh_state(params, axes, train_rules(), dm)
    place = placements_of(axes, params, train_rules(), dm)
    from repro_torch.sharding.logical import tree_of_specs_leaves
    specs = tree_of_specs_leaves(specs_of(axes, params, train_rules(), dm))
    same, split = True, 0
    for p, c, pl in zip(tree_leaves(params), tree_leaves(cut),
                        _leaves_of(place, params)):
        local = distribute_tensor(p, dm, list(pl)).to_local()
        same = same and torch.equal(local, c)
        split += c.numel() < p.numel()
    out["fsdp_blocks_equal_dtensor"] = same
    out["fsdp_leaves_split"] = split
    out["specs"] = specs
    return out


def _leaves_of(tree, like):
    """The placement tuples of ``tree`` in ``like``'s leaf order."""
    flat = []

    def rec(node, ref):
        if isinstance(ref, dict):
            for k in sorted(ref):
                rec(node[k], ref[k])
        else:
            flat.append(node)
    rec(tree, like)
    assert len(flat) == len(tree_leaves(like))
    return flat
