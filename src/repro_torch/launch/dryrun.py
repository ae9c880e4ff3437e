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
        _unregister_pointwise()
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
# ``DTensor`` partitions some ops otherwise than GSPMD does, and refuses
# others.  GSPMD pads a dimension that does not divide its shards and
# tiles a reshape over two dimensions; ``DTensor`` would all-gather a
# weight to slice its packed checksum lanes off, or refuse to split 8 KV
# heads over a model axis of 16.  It keeps a partial sum through a
# product (and all-gathers the weight instead), makes a buffer shaped
# like a sharded tensor whole, all-gathers rows for a log-sum-exp over
# a sharded dimension or for a gather or scatter along one (the label's
# logit, a decode step's cache row), and lacks strategies for a few ops
# in older releases.  :func:`gspmd_hook`, the counter's
# ``dtensor_hook``, takes each of these as GSPMD does, and
# :class:`GspmdGather` the gather above autograd (so that its gradient
# stays sharded too): the reckoned program is JAX's partitioned one;
# every other op is ``DTensor``'s own.

_RESHAPES = {"view", "reshape", "_unsafe_view"}
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm"}


_FACTORIES = {"new_zeros", "new_empty", "new_ones", "new_full"}
#: elementwise ops whose DTensor strategy has been seen to exist in this
#: fake world
_CHECKED: set = set()
#: what :func:`_register_pointwise` added to DTensor's sharding
#: propagator in this fake world: (op, the propagator's tables it
#: entered); :func:`fake_world` takes them out again on exit
_REGISTERED: list = []


def _propagator():
    from torch.distributed.tensor import DTensor
    return DTensor._op_dispatcher.sharding_propagator


def _register_pointwise(func) -> bool:
    """Give ``func`` DTensor's elementwise strategy (its module's own
    registration, across PyTorch releases) until the fake world ends;
    False where neither form exists."""
    from torch.distributed.tensor._ops import _pointwise_ops as pw
    prop = _propagator()
    tables = {k: v for k, v in vars(prop).items() if isinstance(v, dict)}
    had = {k for k, t in tables.items() if func in t}
    if hasattr(pw, "_register_single_dim_pointwise"):
        pw._register_single_dim_pointwise(func)
    elif hasattr(pw, "pointwise_strategy"):
        prop.register_op_strategy(func, pw.pointwise_strategy)
    else:
        return False
    _REGISTERED.append((func, [k for k, t in tables.items()
                               if func in t and k not in had]))
    return True


def _unregister_pointwise() -> None:
    """Take :func:`_register_pointwise`'s strategies out of DTensor's
    process-wide propagator (and its cache of propagated shardings)."""
    if _REGISTERED:
        prop = _propagator()
        for func, names in _REGISTERED:
            for name in names:
                getattr(prop, name).pop(func, None)
        cache = getattr(prop.propagate_op_sharding, "cache_clear", None)
        if cache is not None:
            cache()
    _REGISTERED.clear()
    _CHECKED.clear()


def _factory_like(func, x, args, kwargs):
    """``x.new_*(size)`` of ``x``'s rank, or of a prefix of ``x``'s shape
    (a flash attention's running max), sharded as ``x`` along every
    dimension whose size it keeps, replicated along the others."""
    from torch.distributed.tensor import DTensor, Replicate
    name = func.overloadpacket.__name__
    dtype = kwargs.get("dtype") or x.dtype
    size = torch.Size(args[1])
    placements = [p if not _is_shard(p) or p.dim < len(size) and
                  size[p.dim] == x.shape[p.dim] else Replicate()
                  for p in x.placements]
    placements = [p if _is_shard(p) or p.is_replicate() else Replicate()
                  for p in placements]
    local = list(size)
    for i, p in enumerate(placements):
        if _is_shard(p):
            local[p.dim] //= x.device_mesh.size(i)
    device = x._local_tensor.device
    kind = {"new_zeros": torch.zeros, "new_empty": torch.empty,
            "new_ones": torch.ones}.get(name)
    if kind is None:
        loc = torch.full(local, args[2], dtype=dtype, device=device)
    else:
        loc = kind(local, dtype=dtype, device=device)
    return DTensor.from_local(loc, x.device_mesh, placements,
                              run_check=False, shape=size,
                              stride=_contiguous_stride(size))


def _view_groups(src, dst) -> list:
    """The dimensions of a reshape from ``src`` to ``dst`` in groups of
    equal element count: ``[(src dims, dst dims), ...]``."""
    groups, i, j = [], 0, 0
    while i < len(src) or j < len(dst):
        gi, gj = [i] if i < len(src) else [], [j] if j < len(dst) else []
        a = src[i] if i < len(src) else 1
        b = dst[j] if j < len(dst) else 1
        i, j = i + 1, j + 1
        while a != b:
            if a < b and i < len(src):
                a *= src[i]
                gi.append(i)
                i += 1
            elif j < len(dst):
                b *= dst[j]
                gj.append(j)
                j += 1
            else:
                break
        groups.append((gi, gj))
    return groups


def _infer_shape(numel: int, shape) -> torch.Size:
    """A reshape's result shape, its ``-1`` filled in (without making a
    tensor: under the counter that would count as an allocation)."""
    shape = list(shape)
    if -1 in shape:
        rest = 1
        for d in shape:
            if d != -1:
                rest *= d
        shape[shape.index(-1)] = numel // rest if rest else 0
    return torch.Size(shape)


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


def _reshard(out, src_shape, freed):
    """Shard ``out`` again over each mesh axis in ``freed`` (``(axis,
    source dim)``) along the first dimension of its source dim's group
    that the axis divides and no other axis shards."""
    from torch.distributed.tensor import Shard
    placements = list(out.placements)
    groups = _view_groups(list(src_shape), list(out.shape))
    for axis, d in freed:
        k = out.device_mesh.size(axis)
        taken = {p.dim for p in placements if _is_shard(p)}
        dst = next((g for s_, g in groups if d in s_), [])
        pick = next((o for o in dst if out.shape[o] % k == 0
                     and o not in taken), None)
        if pick is not None:
            placements[axis] = Shard(pick)
    if placements != list(out.placements):
        out = out.redistribute(out.device_mesh, placements)
    return out


def _reduces_sharded(x, dims) -> bool:
    dims = [dims] if isinstance(dims, int) else list(dims)
    return any(_shard_axes(x, d % x.dim()) for d in dims)


def _partial(x) -> bool:
    return any(p.is_partial() and "MaskPartial" not in type(p).__name__
               for p in x.placements)


def _is_shard(p) -> bool:
    """A placement that splits a tensor dimension (``Shard`` or
    ``_StridedShard``, which is not a ``Shard``)."""
    return p.is_shard() or "StridedShard" in type(p).__name__


def _masked(x) -> bool:
    """``x`` holds a masked partial (``DTensor``'s vocab-parallel gather
    and embedding), which a view would leave with a mask of the wrong
    shape."""
    return any("MaskPartial" in type(p).__name__ for p in x.placements)


def _shard_axes(x, dim: int, strided: bool = True) -> list:
    """The mesh axes that split ``x``'s dimension ``dim`` (strided
    shards among them unless ``strided`` is False)."""
    return [i for i, p in enumerate(x.placements)
            if (_is_shard(p) if strided else p.is_shard()) and p.dim == dim]


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(d, 1)
    return tuple(reversed(stride))


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


def _index(counter, func, x, args, kwargs):
    """GSPMD's gather (``x[i, :, j]``) or scatter (``x[i, :, j] = v``)
    along sharded dimensions: each rank's own op on its shard (indices
    off its shard touch nothing); a gather's result a partial sum over
    the axes that shard an indexed dimension, reduced across them, and
    split as its indices are over the axes ``x`` is whole on (a token
    table's lookup keeps the batch's split); a scatter's indices and
    values made whole.  ``DTensor`` would all-gather the indexed
    dimensions (a decode step's cache write, every layer; the token
    table, every step).  ``NotImplemented`` unless every sharded
    dimension of ``x`` is indexed."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    indices = list(args[1])
    indexed = {d for d, i in enumerate(indices) if i is not None}
    sharded = {p.dim for p in x.placements if _is_shard(p)}
    if not sharded or not sharded <= indexed or any(
            not (p.is_shard() or p.is_replicate()) for p in x.placements):
        return NotImplemented
    mesh = x.device_mesh
    name = func.overloadpacket.__name__
    if name != "index":
        def whole(a):
            if not isinstance(a, DTensor):
                return a
            return a.redistribute(mesh, [Replicate()] *
                                  mesh.ndim)._local_tensor
        with counter:
            loc = func(x._local_tensor, [whole(i) for i in indices],
                       *(whole(a) for a in args[2:]), **kwargs)
            if name == "index_put_":
                return x
            return DTensor.from_local(loc, mesh, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())

    # the broadcast index dims sit where the indexed dims were when those
    # are adjacent, else first (NumPy's rule)
    nb = len(torch.broadcast_shapes(*(i.shape for i in indices
                                      if i is not None)))
    dims = sorted(indexed)
    p0 = dims[0] if dims == list(range(dims[0], dims[-1] + 1)) else 0
    keep = {}                  # mesh axis x is whole on -> broadcast dim
    for a in range(mesh.ndim):
        if x.placements[a].is_shard():
            continue
        split = {i.placements[a].dim + nb - i.dim() for i in indices
                 if isinstance(i, DTensor) and i.placements[a].is_shard()}
        if len(split) > 1:
            return NotImplemented
        if split:
            keep[a] = split.pop()

    def local(i):
        """Rank 0's part of index ``i``: whole over the axes that shard
        ``x``, its first chunk over those in ``keep``."""
        if i is None:
            return None
        own = set()
        if isinstance(i, DTensor):
            i = i.redistribute(mesh, [
                q if a in keep and q.is_shard() else Replicate()
                for a, q in enumerate(i.placements)])
            own = {a for a, q in enumerate(i.placements) if q.is_shard()}
            i = i._local_tensor
        for a, b in keep.items():
            d = b - (nb - i.dim())
            if a not in own and d >= 0 and i.shape[d] > 1:
                i = i.narrow(d, 0, -(-i.shape[d] // mesh.size(a)))
        return i

    # the global result's shape, reckoned outside the counter
    shape = func(torch.empty(x.shape, dtype=x.dtype, device="meta"),
                 [None if i is None else torch.empty(
                     i.shape, dtype=i.dtype, device="meta")
                  for i in indices]).shape
    part = [Partial() if p.is_shard() else Shard(p0 + keep[a]) if a in keep
            else Replicate() for a, p in enumerate(x.placements)]
    with counter:
        loc = func(x._local_tensor, [local(i) for i in indices])
        y = DTensor.from_local(loc, mesh, part, run_check=False,
                               shape=shape, stride=_contiguous_stride(shape))
        return y.redistribute(mesh, [Replicate() if q.is_partial() else q
                                     for q in part])


class GspmdGather(torch.overrides.TorchFunctionMode):
    """The dry run's gather along a sharded dimension (the label's logit
    in the cross-entropy, over a vocabulary sharded on ``model``), taken
    above autograd as GSPMD partitions it: each rank gathers from its
    own shard (indices off it give 0) and the partial sums are reduced
    across the shards.  Its gradient is then each rank's scatter into
    its own shard, where ``DTensor`` would make the gradient's buffer
    over the whole vocabulary."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func in (torch.gather, torch.Tensor.gather) and not kwargs:
            out = _gather(*args)
            if out is not None:
                return out
        return func(*args, **kwargs)


def _gather(x, dim, index, *rest):
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if rest or not isinstance(x, DTensor) or \
            not isinstance(index, DTensor):
        return None
    dim = dim % x.dim()
    axes = _shard_axes(x, dim)
    if not axes or any(not x.placements[i].is_shard() for i in axes) or \
            any(p != q for i, (p, q) in enumerate(
                zip(x.placements, index.placements)) if i not in axes):
        return None
    # rank 0's shard holds the first rows of ``dim``
    loc = x.to_local()
    il = index.to_local()
    n = loc.shape[dim]
    hit = il < n
    g = torch.gather(loc, dim, torch.clamp(il, 0, n - 1))
    g = torch.where(hit, g, torch.zeros((), dtype=g.dtype, device=g.device))
    part = [Partial() if i in axes else p for i, p in enumerate(x.placements)]
    y = DTensor.from_local(g, x.device_mesh, part, run_check=False,
                           shape=index.shape,
                           stride=_contiguous_stride(index.shape))
    return y.redistribute(x.device_mesh, [
        Replicate() if i in axes else p for i, p in enumerate(part)])


def gspmd_hook(counter, func, args, kwargs):
    """:class:`CostCounter`'s ``dtensor_hook`` for the dry run: the ops
    the comment above names, as GSPMD partitions them; ``NotImplemented``
    (``DTensor``'s own way) for every other op."""
    from torch.distributed.tensor import DTensor, Replicate
    name = func.overloadpacket.__name__
    if func.namespace == "c10d":
        # a torch.distributed collective over a group (the deferred
        # step's data axis, manual as under JAX's shard_map): each rank
        # reduces its own shards
        def local(a):
            if isinstance(a, DTensor):
                return a._local_tensor
            if isinstance(a, (list, tuple)):
                return type(a)(local(b) for b in a)
            return a
        with counter:
            return func(*local(list(args)), **kwargs)
    if name in _PRODUCTS and any(
            isinstance(a, DTensor) and _partial(a) for a in args):
        # GSPMD reduces a partial sum before a product consumes it;
        # DTensor would keep it and all-gather the weight instead
        with counter:
            return func(*(a.redistribute(a.device_mesh, [
                Replicate() if p.is_partial() else p for p in a.placements])
                if isinstance(a, DTensor) and _partial(a) else a
                for a in args), **kwargs)
    if func not in _CHECKED and torch.Tag.pointwise in func.tags:
        # an elementwise op this PyTorch's DTensor has no strategy for
        # (older releases lack the comparisons): registered as one
        _CHECKED.add(func)
        with counter:
            try:
                return func(*args, **kwargs)
            except NotImplementedError as e:
                if "sharding strategy" not in str(e) or \
                        not _register_pointwise(func):
                    raise
            return func(*args, **kwargs)
    x = args[0] if args else None
    if not isinstance(x, DTensor):
        return NotImplemented
    if name in _FACTORIES and (len(args[1]) == x.dim() or tuple(
            args[1]) == tuple(x.shape[:len(args[1])])):
        # a buffer of ``x``'s rank (a slice's backward) or of its leading
        # dimensions is laid out as ``x`` along the dimensions they
        # share: DTensor would replicate it whole
        with counter:
            return _factory_like(func, x, args, kwargs)
    if name in ("index", "index_put", "index_put_"):
        out = _index(counter, func, x, args, kwargs)
        if out is not NotImplemented:
            return out
    if name in ("argmax", "argmin") and len(args) > 1 and \
            args[1] is not None and _reduces_sharded(x, args[1]):
        # an index reduction over shards: the rows gathered first
        # (DTensor's own strategy mis-shapes it)
        with counter:
            axes = _shard_axes(x, args[1] % x.dim())
            x = x.redistribute(x.device_mesh, [
                Replicate() if i in axes else p
                for i, p in enumerate(x.placements)])
            return func(x, *args[1:], **kwargs)
    if name == "logsumexp" and _reduces_sharded(x, args[1]):
        # GSPMD's two-stage reduction: the max and the sum of the shards
        # reduced across them; DTensor would all-gather the rows
        with counter:
            dims = args[1]
            keep = args[2] if len(args) > 2 else kwargs.get("keepdim", False)
            m = torch.amax(x, dim=dims, keepdim=True).detach()
            out = torch.log(torch.sum(torch.exp(x - m), dim=dims,
                                      keepdim=True)) + m
            if not keep:
                # one dimension at a time (older DTensor has no strategy
                # for squeeze over a list)
                for d in sorted((d % x.dim() for d in ([dims] if isinstance(
                        dims, int) else dims)), reverse=True):
                    out = out.squeeze(d)
            return out
    is_view = getattr(func, "is_view", False)
    if name not in _RESHAPES and name not in ("slice", "narrow", "select") \
            and not (is_view and _masked(x)):
        return NotImplemented
    with counter:
        if _masked(x):
            x = x.redistribute(x.device_mesh, [
                Replicate() if "MaskPartial" in type(p).__name__ else p
                for p in x.placements])
        rest = list(args[1:])
        if name in ("slice", "narrow", "select"):
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
                             kwargs.get("end", end),
                             kwargs.get("step", step))
            return func(x, *rest, **kwargs) if out is None else out
        if name not in _RESHAPES:
            return func(x, *rest, **kwargs)
        merged = _merge(x, rest[0])
        if merged is not None:
            return merged
        if x.numel() == 0:
            # DTensor's view rules loop forever on an empty tensor: its
            # reshape is replicated and holds nothing
            from torch.distributed.tensor import DTensor
            shape = _infer_shape(0, rest[0])
            return DTensor.from_local(
                torch.empty(shape, dtype=x.dtype, device="meta"),
                x.device_mesh, [Replicate()] * x.device_mesh.ndim,
                run_check=False)
        # a reshape DTensor refuses: replicate over one mesh axis after
        # another, from the last, until it goes; then shard the result
        # over those axes again along a dimension the split made (GSPMD
        # re-tiles such a reshape: a microbatch split [B] -> [A, B/A],
        # 8 KV heads of 64 over a model axis of 16)
        placements = list(x.placements)
        freed = []
        for i in range(len(placements), -1, -1):
            if i < len(placements):
                if not _is_shard(placements[i]):
                    continue
                freed.append((i, placements[i].dim))
                placements[i] = Replicate()
                x = x.redistribute(x.device_mesh, placements)
            try:
                out = func(x, *rest, **kwargs)
            except RuntimeError:
                if not any(_is_shard(p) for p in placements):
                    raise
                continue
            return _reshard(out, x.shape, freed)
        raise AssertionError("unreachable")


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
