"""Multi-pod dry run: every (arch x shape x mesh) cell's step run once on
meta tensors over a fake world (the JAX package's ``launch/dryrun.py``).

    python -m repro_torch.launch.dryrun --arch mistral-large-123b \\
        --shape decode_32k [--mesh single|multi|both] [--out DIR]

JAX lowers and compiles each cell for the production meshes on 512
forced host devices.  The port has no compiler to ask: a cell starts a
fake ``torch.distributed`` world of 256 (or 512) ranks in this process
(the ``fake`` backend, whose collectives move nothing), builds the
production ``DeviceMesh`` — (16, 16) = ("data", "model") single pod,
(2, 16, 16) = ("pod", "data", "model") multi-pod — and places the meta
state, cache and batch on it as ``DTensor`` s by the logical rules
(:func:`repro_torch.sharding.placements_of`).  It then runs JAX's step
once (``make_train_step`` with its accumulation clamp, and its deferred
and ZeRO-1 branches; ``make_prefill_step``; ``make_decode_step``) under
the cost counter (:mod:`repro_torch.launch.costs`), which sees rank 0's
local ops.  No tensor has storage, so a full-width cell needs no memory
and no card: the dry run is CPU work by its nature, as JAX's is.

Per cell ``<out>/<arch>__<shape>__<mesh>.json`` holds JAX's record keys:
  * the run's success (sharding coherence) and its seconds
    (``compile_seconds``: the meta run takes compilation's place),
  * ``memory_per_device`` — the arguments, outputs, temporaries and
    peak a device holds, with the breakdown at the peak by kind,
  * ``cost_per_device`` — flops, HBM bytes and collective bytes,
  * the roofline terms on the H100 (:mod:`repro_torch.launch.roofline`),
    the analytic MODEL_FLOPS and the parameter counts,
  * the collective schedule (:func:`repro_torch.launch.hlo.
    collective_stats`).

Meta tensors take the kernels' plain versions (``kernels.ops`` launches a
kernel only for CUDA tensors), as JAX's CPU dry run counts its XLA path,
not Pallas: every record says ``"kernels": "plain"``.  Skips (recorded):
``long_500k`` for the full-attention archs, as JAX's.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import logging
import os
import sys
import time
import traceback

import torch

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import get_arch, list_archs
from repro_torch.core.tree import tree_map
from repro_torch.launch.costs import CostCounter
from repro_torch.launch.hlo import collective_stats
from repro_torch.launch.mesh import production_shape
from repro_torch.launch.roofline import (count_params, model_flops,
                                         roofline_terms)
from repro_torch.layers.common import Ctx
from repro_torch.models.base import build_model
from repro_torch.sharding.logical import (cache_axes, input_axes,
                                          mesh_shape_of, param_axes,
                                          placements_of, train_state_axes)
from repro_torch.sharding import gspmd
from repro_torch.sharding.gspmd import (_RESHAPES, GspmdGather,  # noqa: F401
                                        _contiguous_stride, _infer_shape,
                                        _is_shard, _masked, _shard_axes,
                                        _view_groups, unregister_pointwise)
from repro_torch.sharding.rules import serve_rules, train_rules

LM_ARCHS = [a for a in list_archs() if a != "dlrm"]

#: train cells whose families the port does not remat per layer (JAX
#: remats RWKV's and whisper's layer scans with no switch)
NO_LAYER_REMAT = ("ssm", "encdec")

#: the operators a cell's step may run on meta tensors: DTensor
#: dispatches a few thousand a second on one core, so a per-token scan
#: over 4k-32k tokens (hymba's Mamba branch, RWKV's float recurrence)
#: would take hours, where XLA counts one trip of its ``while`` body;
#: such a cell ends ``failed`` naming the budget (ROADMAP A8.4).
#: Mistral-large's train_4k, the largest required cell, runs 2.06 M.
MAX_OPS = 3_000_000

#: the PyTorch releases (major.minor) on which every required cell of
#: the grid was run to ``ok``.  DTensor's strategies change from release
#: to release (on 2.11 llama3.2-1b's train_4k and prefill_32k fail), so
#: every record names its release, and one from another carries a flag.
VALIDATED_TORCH = ("2.13",)

#: Ctx overrides for A/B runs (``--set k=v``); ``zero1``,
#: ``deferred_sync``, ``seq_parallel`` and ``moe_token_parallel`` pick
#: the train step and the rule edits, as in JAX
CTX_OVERRIDES: dict = {}


def torch_release_flag() -> str | None:
    """The flag of a record made on a release not in
    :data:`VALIDATED_TORCH`; None on one that is."""
    release = ".".join(torch.__version__.split(".")[:2])
    if release in VALIDATED_TORCH:
        return None
    return (f"torch {torch.__version__} not validated: the grid was run "
            f"on {', '.join(VALIDATED_TORCH)}")


def cell_skip_reason(cfg, shape) -> str | None:
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return ("full-attention: 524k dense-KV decode excluded by "
                "assignment; sub-quadratic archs (rwkv6, hymba) run it")
    return None


def _ctx(**kw) -> Ctx:
    fields = {f.name for f in dataclasses.fields(Ctx)}
    ov = {k: v for k, v in CTX_OVERRIDES.items() if k in fields}
    return Ctx(**kw).replace(**ov)


# ------------------------------ the fake world ------------------------------

@contextlib.contextmanager
def fake_world(n_ranks: int):
    """This process as rank 0 of a ``fake`` world of ``n_ranks`` (no
    collective moves data); the process group is destroyed on exit, and
    the elementwise strategies the dry run gave DTensor are taken out,
    so neither leaks into the next cell."""
    import torch.distributed as dist

    # importing the module registers the "fake" backend
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized: the "
                           "dry run starts its own fake world")
    # DTensor's advice on sequential all-reduces and the CPU group's
    # all-to-all fallback concern real ranks, not a reckoning
    for name in ("torch.distributed.tensor._redistribute",
                 "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=n_ranks)
    try:
        yield
    finally:
        unregister_pointwise()
        dist.destroy_process_group()


def make_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` over the fake world's ranks."""
    from torch.distributed.device_mesh import DeviceMesh
    n = 1
    for s in shape:
        n *= s
    return DeviceMesh("cpu", torch.arange(n).reshape(tuple(shape)),
                      mesh_dim_names=tuple(axes))


def mesh_name(shape) -> str:
    return "pod" + "x".join(str(s) for s in shape)


def _place(t: torch.Tensor, mesh, placements):
    """A meta ``DTensor`` of ``t``'s global shape: rank 0's shard."""
    from torch.distributed.tensor import DTensor, Shard
    local = list(t.shape)
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            local[p.dim] //= mesh.size(i)
    lt = torch.empty(local, dtype=t.dtype, device="meta")
    return DTensor.from_local(lt, mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def place_tree(tree, axes, rules, mesh):
    """``tree`` (meta tensors) as DTensors by its axes tree."""
    placements = placements_of(axes, tree, rules, mesh)
    return _map_leaves(lambda t, p: _place(t, mesh, p), tree, placements)


def _map_leaves(fn, tree, placements):
    if isinstance(tree, torch.Tensor):
        return fn(tree, placements)
    if isinstance(tree, dict):
        return {k: _map_leaves(fn, v, placements[k]) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map_leaves(fn, v, p)
                            for v, p in zip(tree, placements)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_leaves(fn, v, p)
                          for v, p in zip(tree, placements))
    raise TypeError(f"not a tensor tree node: {tree!r}")


def _meta_batch(model, shape) -> dict:
    return {k: torch.empty(s.shape, dtype=s.dtype, device="meta")
            for k, s in model.input_specs(shape).items()}


# ------------------------------ GSPMD's ways --------------------------------
#
# The ways GSPMD partitions ops that ``DTensor`` takes otherwise are
# :mod:`repro_torch.sharding.gspmd`'s, shared with the tensor-parallel
# step on real ranks.  The dry run adds the ones that reckon rank 0's
# shard without its values: GSPMD pads a dimension that does not divide
# its shards (a slice of a sharded dimension stays sharded), selects an
# index of a sharded dimension from its owner, and merges dimensions
# where a sharded one is not the outermost (a gradient flattened for its
# checksum); ``DTensor`` would all-gather for each.


def _merge(x, shape):
    """GSPMD's merge of dimensions where a sharded one is not the
    outermost of its group (a gradient flattened for its checksum): each
    rank keeps its block, now a plain shard of the merged dimension.
    DTensor would make a strided shard, whose view rules take seconds a
    leaf.  None where the reshape is not such a merge."""
    from torch.distributed.tensor import DTensor, Shard
    out_shape = _infer_shape(x.numel(), shape)
    groups = _view_groups(list(x.shape), list(out_shape))
    where = {d: (src, dst) for src, dst in groups for d in src}
    placements, inner = [], False
    local = list(out_shape)
    for i, p in enumerate(x.placements):
        if not _is_shard(p):
            placements.append(p)
            continue
        src, dst = where[p.dim]
        if not p.is_shard() or len(dst) != 1 or \
                out_shape[dst[0]] % x.device_mesh.size(i):
            return None
        if len(src) > 1 and p.dim != src[0]:
            inner = True
        if any(q.is_shard() and q.dim == dst[0] for q in placements):
            return None
        placements.append(Shard(dst[0]))
        local[dst[0]] //= x.device_mesh.size(i)
    n = 1
    for d in local:
        n *= d
    if not inner or n != x._local_tensor.numel():
        return None          # not such a merge, or an uneven local shard
    loc = x._local_tensor.reshape(local)
    return DTensor.from_local(loc, x.device_mesh, placements,
                              run_check=False, shape=out_shape,
                              stride=_contiguous_stride(out_shape))


def _slice(x, dim: int, start, end, step: int):
    """GSPMD's slice of a dimension sharded over one mesh axis: the
    result stays sharded there (padded), each rank holding its chunk;
    rank 0's is the first ``ceil(len / k)`` of its rows.  None where the
    slice is the whole dimension or the dimension is not so sharded."""
    from torch.distributed.tensor import DTensor
    if len(_shard_axes(x, dim)) != len(_shard_axes(x, dim, strided=False)):
        return None        # a strided shard: DTensor's own way
    axes = _shard_axes(x, dim)
    n = x.shape[dim]
    start, end, _ = slice(start, end, step).indices(n)
    length = max(0, -(-(end - start) // step))
    if len(axes) != 1 or (length == n and step == 1):
        return None
    k = x.device_mesh.size(axes[0])
    want = -(-length // k)
    local = x._local_tensor
    if want <= local.shape[dim]:
        loc = local.narrow(dim, 0, want)
    else:
        shape = list(local.shape)
        shape[dim] = want
        loc = torch.empty(shape, dtype=local.dtype, device=local.device)
    shape = list(x.shape)
    shape[dim] = length
    return DTensor.from_local(loc, x.device_mesh, x.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _select(x, dim: int):
    """GSPMD's select of one index of a sharded dimension: the owner's
    row, broadcast (an all-reduce of the masked partial)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    axes = _shard_axes(x, dim)
    if not axes or any(not x.placements[i].is_shard() for i in axes):
        return None
    part, done = [], []
    for i, p in enumerate(x.placements):
        if i in axes:
            part.append(Partial())
            done.append(Replicate())
        elif _is_shard(p) and p.dim > dim:
            part.append(Shard(p.dim - 1))
            done.append(Shard(p.dim - 1))
        else:
            part.append(p)
            done.append(p)
    loc = x._local_tensor.select(dim, 0)
    shape = list(x.shape)
    del shape[dim]
    y = DTensor.from_local(torch.empty_like(loc), x.device_mesh, part,
                           run_check=False, shape=torch.Size(shape),
                           stride=_contiguous_stride(shape))
    return y.redistribute(x.device_mesh, done)


def _reckon(counter, func, x, args, kwargs):
    """The dry run's own branches (the comment above): a slice, narrow or
    select of a sharded dimension, a merging reshape, the reshape of an
    empty tensor; ``NotImplemented`` for every other op."""
    from torch.distributed.tensor import DTensor, Replicate
    name = func.overloadpacket.__name__
    if name not in ("slice", "narrow", "select") and name not in _RESHAPES:
        return NotImplemented
    with counter:
        if _masked(x):
            x = x.redistribute(x.device_mesh, [
                Replicate() if "MaskPartial" in type(p).__name__ else p
                for p in x.placements])
        rest = list(args[1:])
        if name in _RESHAPES:
            merged = _merge(x, rest[0])
            if merged is not None:
                return merged
            if x.numel() == 0:
                # DTensor's view rules loop forever on an empty tensor: its
                # reshape is replicated and holds nothing
                shape = _infer_shape(0, rest[0])
                return DTensor.from_local(
                    torch.empty(shape, dtype=x.dtype, device="meta"),
                    x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                    run_check=False)
            return gspmd._retile(func, x, rest, kwargs)
        dim = rest[0] if rest else kwargs.get("dim", 0)
        dim = dim % x.dim()
        if name == "select":
            out = _select(x, dim)
        elif name == "narrow":
            start = rest[1] % x.shape[dim] if rest[1] < 0 else rest[1]
            out = _slice(x, dim, start, start + rest[2], 1)
        else:
            vals = rest[1:] + [None] * (3 - len(rest[1:]))
            start, end, step = vals[0], vals[1], vals[2] or 1
            out = _slice(x, dim, kwargs.get("start", start),
                         kwargs.get("end", end), kwargs.get("step", step))
        return func(x, *rest, **kwargs) if out is None else out


def gspmd_hook(counter, func, args, kwargs):
    """:class:`CostCounter`'s ``dtensor_hook`` for the dry run: its own
    branches (:func:`_reckon`), then :func:`repro_torch.sharding.gspmd.
    gspmd_hook`'s; ``NotImplemented`` (``DTensor``'s own way) for every
    other op."""
    from torch.distributed.tensor import DTensor
    x = args[0] if args else None
    if isinstance(x, DTensor) and func.namespace != "c10d":
        out = _reckon(counter, func, x, args, kwargs)
        if out is not NotImplemented:
            return out
    return gspmd.gspmd_hook(counter, func, args, kwargs)


# ------------------------------ the steps -----------------------------------

def build_train(model, shape, rules, mesh):
    """-> (run, arguments by kind, parameter tree): JAX's ``build_train``
    with the port's steps; ``run()`` is the step once."""
    from repro_torch.launch import steps
    cfg = model.cfg
    ctx = _ctx(rules=rules, quant=False, abft=False, float_abft=False,
               compute_dtype=torch.bfloat16, wkv_chunk=cfg.wkv_chunk,
               ssm_chunk=cfg.ssm_chunk)
    # microbatches must stay shardable over the batch axes: clamp accum so
    # global_batch/accum is a multiple of the data(+pod) extent
    msz = mesh_shape_of(mesh)
    n_batch_shards = msz.get("data", 1) * msz.get("pod", 1)
    accum = max(1, min(cfg.train_accum, shape.global_batch // n_batch_shards))
    while shape.global_batch // accum % n_batch_shards:
        accum -= 1
    batch = _meta_batch(model, shape)

    if CTX_OVERRIDES.get("zero1") or cfg.zero1:
        # pure data parallelism over every mesh axis + the ZeRO-1 flat
        # optimizer blocks: one data mesh of all the ranks
        from repro_torch.sharding import DataMesh
        flat = make_mesh((mesh.size(),), ("data",))
        dmesh = DataMesh(tuple(range(mesh.size())), flat,
                         flat.get_group("data"))
        state, axes = steps.zero1_state_shapes(model, mesh.size())
        ctx = ctx.replace(rules=None)
        step = steps.make_train_step_zero1(model, ctx, dmesh, accum=1)
        dstate = _local_zero1(state, mesh.size())
        n = mesh.size()
        dbatch = {k: torch.empty((v.shape[0] // n,) + tuple(v.shape[1:]),
                                 dtype=v.dtype, device="meta")
                  for k, v in batch.items()}
        return (lambda: step(dstate, dbatch),
                {"params": dstate["params"], "optimizer": dstate["opt"],
                 "step": dstate["step"], "batch": dbatch}, state["params"])

    if CTX_OVERRIDES.get("deferred_sync") or cfg.deferred_grad_sync:
        # the data axes manual (one rank's local program), parameters
        # replicated over data, one checked int8 gradient collective
        from repro_torch.sharding import DataMesh
        data_axes = ("pod", "data") if "pod" in msz else ("data",)
        n_data = 1
        for a in data_axes:
            n_data *= msz[a]
        group_mesh = make_mesh((n_data,), ("data",))
        dmesh = DataMesh(tuple(range(n_data)), group_mesh,
                         group_mesh.get_group("data"))
        repl = {**rules, "embed": None, "batch": None}
        for a in data_axes:
            repl = {k: (None if v == a else v) for k, v in repl.items()}
        state = steps.train_state_shapes(model, compress=True)
        axes = train_state_axes(state["params"], compress=True)
        # the residual is this rank's own: its parameter's layout
        dstate = place_tree(state, axes, repl, mesh)
        ctx = ctx.replace(rules=repl)
        step = steps.make_train_step_deferred(model, ctx, dmesh,
                                              accum=accum)
        local = {k: torch.empty((v.shape[0] // n_data,) + tuple(v.shape[1:]),
                                dtype=v.dtype, device="meta")
                 for k, v in batch.items()}
        dbatch = place_tree(local, input_axes(model.input_specs(shape)),
                            repl, mesh)
        return (lambda: step(dstate, dbatch),
                {"params": dstate["params"], "optimizer": dstate["opt"],
                 "residuals": dstate["comm"], "step": dstate["step"],
                 "batch": dbatch}, state["params"])

    state = steps.train_state_shapes(model)
    axes = train_state_axes(state["params"])
    dstate = place_tree(state, axes, rules, mesh)
    dbatch = place_tree(batch, input_axes(model.input_specs(shape)), rules,
                        mesh)
    step = steps.make_train_step(model, ctx, accum=accum)
    return (lambda: step(dstate, dbatch),
            {"params": dstate["params"], "optimizer": dstate["opt"],
             "step": dstate["step"], "batch": dbatch}, state["params"])


def _local_zero1(state, n: int) -> dict:
    """The ZeRO-1 state as rank 0 holds it: the bf16 parameters whole,
    a 1/n block of each flat vector."""
    def block(t):
        return torch.empty((t.shape[0] // n,), dtype=t.dtype, device="meta")
    return {"params": tree_map(lambda p: torch.empty_like(p, device="meta"),
                               state["params"]),
            "opt": {k: block(v) for k, v in state["opt"].items()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def build_prefill(model, shape, rules, mesh):
    from repro_torch.launch.steps import make_prefill_step
    cfg = model.cfg
    ctx = _ctx(rules=rules, quant=True, abft=True,
               compute_dtype=torch.bfloat16, wkv_chunk=cfg.wkv_chunk,
               ssm_chunk=cfg.ssm_chunk)
    step = make_prefill_step(model, ctx, cache_len=shape.seq_len)
    params = model.init(0, quant=True, device="meta")
    dparams = place_tree(params, param_axes(params), rules, mesh)
    dbatch = place_tree(_meta_batch(model, shape),
                        input_axes(model.input_specs(shape)), rules, mesh)
    return (lambda: step(dparams, dbatch),
            {"params": dparams, "batch": dbatch}, params)


def build_decode(model, shape, rules, mesh):
    from repro_torch.launch.steps import make_decode_step
    ctx = _ctx(rules=rules, quant=True, abft=True,
               compute_dtype=torch.bfloat16)
    step = make_decode_step(model, ctx)
    params = model.init(0, quant=True, device="meta")
    dparams = place_tree(params, param_axes(params), rules, mesh)
    cache = model.init_cache(shape.global_batch, shape.seq_len,
                             device="meta")
    dcache = place_tree(cache, cache_axes(cache), rules, mesh)
    dbatch = place_tree(_meta_batch(model, shape),
                        input_axes(model.input_specs(shape)), rules, mesh)
    return (lambda: step(dparams, dcache, dbatch["tokens"], dbatch["pos"]),
            {"params": dparams, "cache": dcache, "batch": dbatch}, params)


BUILD = {"train": build_train, "prefill": build_prefill,
         "decode": build_decode}


def rules_for(cfg, shape, multi_pod: bool) -> dict:
    """JAX's rules for the cell: train or serve, with the
    ``seq_parallel`` and ``moe_token_parallel`` edits of a train cell."""
    rules = (train_rules(multi_pod) if shape.kind == "train"
             else serve_rules(multi_pod))
    if (CTX_OVERRIDES.get("seq_parallel", cfg.seq_parallel)
            and shape.kind == "train"):
        rules = {**rules, "seq": "model"}
    if CTX_OVERRIDES.get("moe_token_parallel",
                         cfg.moe_token_parallel) and shape.kind == "train":
        rules = {**rules, "expert": None, "expert_mlp": None,
                 "moe_tokens": "model"}
    return rules


def run_step(model, shape, rules, mesh, *, attribute: bool = False):
    """Build the cell's step and run it once under a counter; -> (the
    counter, the parameter tree)."""
    from torch.distributed.tensor.experimental import implicit_replication
    run, args, params = BUILD[shape.kind](model, shape, rules, mesh)
    counter = CostCounter(attribute=attribute, dtensor_hook=gspmd_hook,
                          max_ops=MAX_OPS)
    counter.arguments(args)
    # the layers' plain tensors (RoPE tables, masks, constants) take part
    # as replicated: a property of reckoning on DTensors, not of the
    # layers
    with implicit_replication(), GspmdGather(), counter:
        out = run()
    counter.outputs(out)
    del out
    return counter, params


def run_cell(arch: str, shape_name: str, multi_pod: bool, out_dir: str, *,
             skip_existing: bool = False, cfg=None, shape=None,
             mesh_shape=None) -> dict:
    """One cell: its record, written to ``out_dir``.  For reduced cells
    ``cfg`` replaces the registry's config,
    ``shape`` (a ``ShapeConfig``) ``SHAPES[shape_name]`` and
    ``mesh_shape`` (``(shape, axes)``) the production mesh."""
    shape_, axes = mesh_shape or production_shape(multi_pod)
    name = mesh_name(shape_)
    out_path = os.path.join(out_dir, f"{arch}__{shape_name}__{name}.json")
    if skip_existing and os.path.exists(out_path):
        with open(out_path) as f:
            return json.load(f)

    cfg = cfg or get_arch(arch)
    shape = shape or SHAPES[shape_name]
    rec = {
        "arch": arch, "shape": shape_name, "mesh": name,
        "kind": shape.kind, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch, "kernels": "plain",
        "torch": torch.__version__,
    }
    reason = cell_skip_reason(cfg, shape)
    if reason:
        rec.update(status="skipped", skip_reason=reason)
        _write(out_path, rec)
        return rec

    n_dev = 1
    for s in shape_:
        n_dev *= s
    rec["n_devices"] = int(n_dev)
    rules = rules_for(cfg, shape, multi_pod)
    max_pos = max(shape.seq_len, 4096) + cfg.meta_tokens + 1
    model = build_model(cfg, max_pos=max_pos)
    flags = [f for f in (torch_release_flag(),) if f]
    if shape.kind == "train" and cfg.family in NO_LAYER_REMAT:
        flags.append("no layer remat (ROADMAP A8.4)")

    t0 = time.time()
    try:
        with fake_world(n_dev):
            mesh = make_mesh(shape_, axes)
            counter, params = run_step(model, shape, rules, mesh)
    except Exception as e:  # noqa: BLE001 — recorded as the cell's failure
        rec.update(status="failed", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-3000:])
        _write(out_path, rec)
        return rec
    rec["compile_seconds"] = round(time.time() - t0, 1)
    t1 = time.time()
    rec["memory_per_device"] = counter.memory()
    cost = counter.result()
    cost["flags"] = flags + cost["flags"]
    # XLA's cost_analysis counts a while body once; an eager program has
    # no loop construct, so its count "once" is the whole count
    rec["xla_cost_once"] = {"flops": cost["flops"],
                            "bytes_accessed": cost["bytes"]}
    rec["cost_per_device"] = cost
    rec["collective_stats"] = collective_stats(counter.collective_log)
    rec["operators"] = counter.n_ops
    rec["analyze_seconds"] = round(time.time() - t1, 1)
    rec["roofline"] = roofline_terms(cost, n_devices=n_dev)

    # analytic useful-work floor
    active_frac = (cfg.top_k / cfg.n_experts) if cfg.n_experts else None
    counts = count_params(params, active_moe=active_frac)
    tokens = (shape.global_batch * shape.seq_len
              if shape.kind != "decode" else shape.global_batch)
    mf = model_flops(shape.kind, counts["active"], tokens=tokens)
    rec["params"] = counts
    rec["model_flops_global"] = mf
    counted_global = cost["flops"] * n_dev
    rec["model_vs_hlo"] = mf / counted_global if counted_global else None
    rec["status"] = "ok"
    _write(out_path, rec)
    return rec


def _write(path: str, rec: dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        json.dump(rec, f, indent=1, default=float)


def parse_set(items) -> None:
    """``--set K=V`` into :data:`CTX_OVERRIDES` (JAX's parsing)."""
    for kv in items:
        k, v = kv.split("=", 1)
        CTX_OVERRIDES[k] = (int(v) if v.lstrip("-").isdigit()
                            else v == "True" if v in ("True", "False")
                            else float(v) if "." in v else v)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.dryrun",
                                 description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None,
                    help="one arch id (default: all LM archs)")
    ap.add_argument("--shape", default=None,
                    help="one shape name (default: all four)")
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--out", default="artifacts/dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--set", action="append", default=[],
                    metavar="K=V", help="Ctx override, e.g. wkv_chunk=16")
    args = ap.parse_args(argv)
    if args.arch is not None and args.arch not in LM_ARCHS:
        ap.error(f"--arch {args.arch}: the dry run covers {LM_ARCHS}")
    if args.shape is not None and args.shape not in SHAPES:
        ap.error(f"--shape {args.shape}: one of {sorted(SHAPES)}")
    parse_set(args.set)
    if torch_release_flag():
        print(f"warning: {torch_release_flag()}", file=sys.stderr,
              flush=True)

    archs = [args.arch] if args.arch else LM_ARCHS
    shapes = [args.shape] if args.shape else list(SHAPES)
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    failures = 0
    for arch in archs:
        for shape in shapes:
            for mp in meshes:
                rec = run_cell(arch, shape, mp, args.out,
                               skip_existing=args.skip_existing)
                status = rec["status"]
                extra = ""
                if status == "ok":
                    r = rec["roofline"]
                    m = rec["memory_per_device"]
                    extra = (f" compute={r['compute_s']:.3e}s "
                             f"mem={r['memory_s']:.3e}s "
                             f"coll={r['collective_s']:.3e}s "
                             f"dom={r['dominant']} "
                             f"args={m['argument_bytes'] / 2**30:.2f}GiB "
                             f"peak={m['peak_estimate_bytes'] / 2**30:.2f}GiB"
                             f" run={rec['compile_seconds']}s")
                elif status == "failed":
                    failures += 1
                    extra = " " + rec["error"][:160]
                print(f"[{status:7s}] {arch} × {shape} × "
                      f"{'multi' if mp else 'single'}{extra}", flush=True)
    if failures:
        print(f"{failures} cell(s) failed", flush=True)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())


__all__ = ["LM_ARCHS", "CTX_OVERRIDES", "VALIDATED_TORCH",
           "torch_release_flag", "cell_skip_reason", "fake_world",
           "make_mesh", "place_tree", "build_train", "build_prefill",
           "build_decode", "rules_for", "run_step", "run_cell", "main"]
