"""GSPMD's ways with ``DTensor`` ops, shared by the dry run and the
tensor-parallel step on real ranks.

``DTensor`` partitions some ops otherwise than GSPMD does, and refuses
others.  It keeps a partial sum through a product (and all-gathers the
weight instead), makes a buffer shaped like a sharded tensor whole,
all-gathers rows for a log-sum-exp over a sharded dimension or for a
gather or scatter along one (the label's logit, a decode step's cache
row, a token's row of the table), mis-shapes an index reduction over
shards, leaves a masked partial that a view then mis-shapes, refuses
reshapes GSPMD re-tiles, and lacks strategies for a few elementwise ops
in older releases (and, on some, for the token table's gradient).

:func:`gspmd_hook` takes each of these as GSPMD does; every other op is
``DTensor``'s own.  Each branch computes this rank's values: a gather or
scatter along a sharded dimension shifts the indices by this rank's
offset in that dimension and masks the ones off its shard, so the same
code reckons rank 0's shard on the dry run's meta tensors
(:mod:`repro_torch.launch.dryrun`, under its cost counter) and computes
every rank's on a launched world (:class:`GspmdMode`, the
tensor-parallel train step).  :class:`GspmdGather` takes the
cross-entropy's gather above autograd, so that its gradient stays
sharded; :func:`vocab_lookup` is the token table's lookup over a
vocabulary split on the model axis, written out with its gradient.
"""
from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_RESHAPES = {"view", "reshape", "_unsafe_view"}
_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm"}
_FACTORIES = {"new_zeros", "new_empty", "new_ones", "new_full"}

#: elementwise ops whose DTensor strategy has been seen to exist
_CHECKED: set = set()
#: what :func:`_register_pointwise` added to DTensor's sharding
#: propagator: (op, the propagator's tables it entered);
#: :func:`unregister_pointwise` takes them out again
_REGISTERED: list = []


# ------------------------------ placements ----------------------------------

def is_dtensor(x) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def _is_shard(p) -> bool:
    """A placement that splits a tensor dimension (``Shard`` or
    ``_StridedShard``, which is not a ``Shard``)."""
    return p.is_shard() or "StridedShard" in type(p).__name__


def _shard_axes(x, dim: int, strided: bool = True) -> list:
    """The mesh axes that split ``x``'s dimension ``dim`` (strided
    shards among them unless ``strided`` is False)."""
    return [i for i, p in enumerate(x.placements)
            if (_is_shard(p) if strided else p.is_shard()) and p.dim == dim]


def _partial(x) -> bool:
    return any(p.is_partial() and "MaskPartial" not in type(p).__name__
               for p in x.placements)


def _masked(x) -> bool:
    """``x`` holds a masked partial (``DTensor``'s vocab-parallel gather
    and embedding), which a view would leave with a mask of the wrong
    shape."""
    return any("MaskPartial" in type(p).__name__ for p in x.placements)


def _contiguous_stride(shape) -> tuple:
    stride, acc = [], 1
    for d in reversed(tuple(shape)):
        stride.append(acc)
        acc *= max(d, 1)
    return tuple(reversed(stride))


def local_box(x) -> tuple:
    """(local shape, global offset) of this rank's shard of ``x``."""
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    return compute_local_shape_and_global_offset(x.shape, x.device_mesh,
                                                 x.placements)


def _chunk(n: int, k: int, i: int) -> tuple:
    """(start, length) of chunk ``i`` of ``n`` rows cut in ``k``, as
    ``Shard`` cuts them (``torch.chunk``: the last may be short)."""
    size = -(-n // k)
    start = min(i * size, n)
    return start, max(0, min(size, n - start))


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
    tensor: under the cost counter that would count as an allocation)."""
    shape = list(shape)
    if -1 in shape:
        rest = 1
        for d in shape:
            if d != -1:
                rest *= d
        shape[shape.index(-1)] = numel // rest if rest else 0
    return torch.Size(shape)


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
    """A reduction over ``dims`` of ``x`` crosses its shards (a mesh axis
    of one rank splits nothing)."""
    dims = [dims] if isinstance(dims, int) else list(dims)
    return any(x.device_mesh.size(a) > 1 for d in dims
               for a in _shard_axes(x, d % x.dim()))


# ------------------------------ elementwise strategies ----------------------

def _propagator():
    from torch.distributed.tensor import DTensor
    return DTensor._op_dispatcher.sharding_propagator


def _register_pointwise(func) -> bool:
    """Give ``func`` DTensor's elementwise strategy (its module's own
    registration, across PyTorch releases); False where neither form
    exists."""
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


def unregister_pointwise() -> None:
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


# ------------------------------ the branches --------------------------------

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
    mesh = x.device_mesh
    coord = mesh.get_coordinate() or [0] * mesh.ndim
    for i, p in enumerate(placements):
        if _is_shard(p):
            local[p.dim] = _chunk(local[p.dim], mesh.size(i), coord[i])[1]
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


def _shift(i, d: int, x, box):
    """Index ``i`` of ``x``'s dimension ``d`` on this rank's shard: (the
    local index, clamped into the shard; whether it lies on the shard,
    or None where ``d`` is whole here)."""
    local, offset = box
    if local[d] == x.shape[d]:
        return i, None
    g = i.long()
    g = torch.where(g < 0, g + x.shape[d], g)
    j = g - offset[d]
    hit = (j >= 0) & (j < local[d])
    return torch.clamp(j, 0, max(local[d] - 1, 0)), hit


def _index_layout(indices, ndim: int):
    """(where the broadcast index dimensions sit in an ``index`` result,
    the dimensions of ``x`` after them): the indexed dimensions' place
    when they are adjacent, else first (NumPy's rule)."""
    dims = sorted(d for d, i in enumerate(indices) if i is not None)
    if dims == list(range(dims[0], dims[-1] + 1)):
        return dims[0], ndim - dims[-1] - 1
    return 0, ndim - len(dims)


def _hit_view(hit, p0: int, n_after: int):
    """``hit`` (the broadcast index shape) laid out as the ``index``
    result is: ``p0`` ones before it, ``n_after`` after."""
    return hit.reshape((1,) * p0 + tuple(hit.shape) + (1,) * n_after)


def _index(counter, func, x, args, kwargs):
    """GSPMD's gather (``x[i, :, j]``) or scatter (``x[i, :, j] = v``)
    along sharded dimensions: each rank's own op on its shard, its
    indices shifted by the shard's offset; an index off the shard reads
    0 (a gather) or writes nothing (a scatter's value there is masked
    to 0 when it adds, and is the entry it would land on when it sets).
    A gather's result is a partial sum over the axes that shard an
    indexed dimension, reduced across them, and split as its indices
    are over the axes ``x`` is whole on (a token table's lookup keeps
    the batch's split); a scatter's indices and values are made whole.
    ``DTensor`` would all-gather the indexed dimensions (a decode step's
    cache write, every layer).  ``NotImplemented`` unless every sharded
    dimension of ``x`` is indexed by an integer tensor."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    indices = list(args[1])
    indexed = {d for d, i in enumerate(indices) if i is not None}
    sharded = {p.dim for p in x.placements if _is_shard(p)}
    if not sharded or not sharded <= indexed or any(
            not (p.is_shard() or p.is_replicate()) for p in x.placements) \
            or any(i is not None and (i.dtype == torch.bool or
                                      i.is_floating_point())
                   for i in indices):
        return NotImplemented
    mesh = x.device_mesh
    name = func.overloadpacket.__name__
    box = local_box(x)
    p0, n_after = _index_layout(indices, x.dim())
    if name != "index":
        def whole(a):
            if not isinstance(a, DTensor):
                return a
            return a.redistribute(mesh, [Replicate()] *
                                  mesh.ndim)._local_tensor
        with counter:
            loc_x = x._local_tensor
            moved = [None if i is None else _shift(whole(i), d, x, box)
                     for d, i in enumerate(indices)]
            idx = [None if m is None else m[0] for m in moved]
            hits = [m[1] for m in moved if m is not None and m[1] is not None]
            vals = whole(args[2])
            rest = list(args[3:])
            if hits:
                hit = hits[0]
                for h in hits[1:]:
                    hit = hit & h
                hit = _hit_view(hit, p0, n_after)
                accumulate = rest[0] if rest else kwargs.get("accumulate",
                                                             False)
                if accumulate:
                    vals = torch.where(hit, vals, torch.zeros(
                        (), dtype=vals.dtype, device=vals.device))
                else:
                    vals = torch.where(hit, vals, torch.ops.aten.index.Tensor(
                        loc_x, idx).to(vals.dtype))
            loc = func(loc_x, idx, vals, *rest, **kwargs)
            if name == "index_put_":
                return x
            return DTensor.from_local(loc, mesh, x.placements,
                                      run_check=False, shape=x.shape,
                                      stride=x.stride())

    nb = len(torch.broadcast_shapes(*(i.shape for i in indices
                                      if i is not None)))
    coord = mesh.get_coordinate() or [0] * mesh.ndim
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
        """This rank's part of index ``i``: whole over the axes that
        shard ``x``, its own chunk over those in ``keep``."""
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
                i = i.narrow(d, *_chunk(i.shape[d], mesh.size(a), coord[a]))
        return i

    # the global result's shape, reckoned outside the counter
    shape = func(torch.empty(x.shape, dtype=x.dtype, device="meta"),
                 [None if i is None else torch.empty(
                     i.shape, dtype=i.dtype, device="meta")
                  for i in indices]).shape
    part = [Partial() if p.is_shard() else Shard(p0 + keep[a]) if a in keep
            else Replicate() for a, p in enumerate(x.placements)]
    with counter:
        moved = [None if i is None else _shift(local(i), d, x, box)
                 for d, i in enumerate(indices)]
        loc = func(x._local_tensor, [None if m is None else m[0]
                                     for m in moved])
        hits = [m[1] for m in moved if m is not None and m[1] is not None]
        if hits:
            hit = hits[0]
            for h in hits[1:]:
                hit = hit & h
            loc = torch.where(_hit_view(hit, p0, n_after), loc, torch.zeros(
                (), dtype=loc.dtype, device=loc.device))
        y = DTensor.from_local(loc, mesh, part, run_check=False,
                               shape=shape, stride=_contiguous_stride(shape))
        return y.redistribute(mesh, [Replicate() if q.is_partial() else q
                                     for q in part])


class GspmdGather(torch.overrides.TorchFunctionMode):
    """A gather along a sharded dimension (the label's logit in the
    cross-entropy, over a vocabulary sharded on ``model``), taken above
    autograd as GSPMD partitions it: each rank gathers from its own
    shard (indices off it give 0) and the partial sums are reduced
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
    loc = x.to_local()
    j, hit = _shift(index.to_local(), dim, x, local_box(x))
    g = torch.gather(loc, dim, j)
    if hit is not None:
        g = torch.where(hit, g, torch.zeros((), dtype=g.dtype,
                                            device=g.device))
    part = [Partial() if i in axes else p for i, p in enumerate(x.placements)]
    y = DTensor.from_local(g, x.device_mesh, part, run_check=False,
                           shape=index.shape,
                           stride=_contiguous_stride(index.shape))
    return y.redistribute(x.device_mesh, [
        Replicate() if i in axes else p for i, p in enumerate(part)])


def _no_strategy(e: BaseException, func) -> bool:
    """``e`` is DTensor's refusal of an op it has no strategy for: a
    ``NotImplementedError`` saying so, or the ``RuntimeError`` of its
    propagation that wraps one, or its table's ``KeyError`` of ``func``
    (releases and paths differ)."""
    while e is not None:
        if "sharding strategy" in str(e) or (
                isinstance(e, KeyError) and e.args and e.args[0] == func):
            return True
        e = e.__cause__ or e.__context__
    return False


def gspmd_hook(counter, func, args, kwargs):
    """A ``dtensor_hook``: the ops the module docstring names, as GSPMD
    partitions them, run under ``counter`` (re-entered, so what they run
    goes through it: the cost counter counts it, :class:`GspmdMode`
    passes it on); ``NotImplemented`` (``DTensor``'s own way) for every
    other op."""
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
            except (NotImplementedError, RuntimeError) as e:
                if not _no_strategy(e, func) or \
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
    if name not in _RESHAPES and not (getattr(func, "is_view", False)
                                      and _masked(x)):
        return NotImplemented
    with counter:
        if _masked(x):
            # a view of a masked partial: the partial reduced first
            x = x.redistribute(x.device_mesh, [
                Replicate() if "MaskPartial" in type(p).__name__ else p
                for p in x.placements])
        if name not in _RESHAPES:
            return func(x, *args[1:], **kwargs)
        return _retile(func, x, list(args[1:]), kwargs)


def _retile(func, x, rest, kwargs):
    """A reshape DTensor refuses: replicate over one mesh axis after
    another, from the last, until it goes; then shard the result over
    those axes again along a dimension the split made (GSPMD re-tiles
    such a reshape: a microbatch split [B] -> [A, B/A], 8 KV heads of 64
    over a model axis of 16)."""
    from torch.distributed.tensor import Replicate
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


class GspmdMode(TorchDispatchMode):
    """:func:`gspmd_hook` on a launched world: each ``DTensor`` op goes
    to the hook first, and runs ``DTensor``'s own way where the hook
    returns ``NotImplemented``; what the hook runs on local tensors
    passes through.  The tensor-parallel train step runs under it.

    On a gloo group (the CPU's ranks, and ranks that share a card)
    ``DTensor``'s functional collectives are run as ``torch.distributed``'s
    own, synchronous, on contiguous tensors (:func:`_gloo_collective`):
    under torch 2.11 gloo's functional all-gather of a CUDA tensor
    crashed the process, where its ``all_gather_into_tensor`` runs."""

    def __init__(self):
        super().__init__()
        self._hooking = False
        #: the results of the collectives run here, done when made
        self._done = weakref.WeakValueDictionary()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            if self._hooking:
                # DTensor's own way, with this mode still on the stack
                # (so that its collectives come back here)
                return NotImplemented
            self._hooking = True
            try:
                return gspmd_hook(self, func, args, kwargs)
            finally:
                self._hooking = False
        if func.namespace == "_c10d_functional":
            out = _gloo_collective(func, args, kwargs, self._done)
            if out is not NotImplemented:
                return out
        return func(*args, **kwargs)


_REDUCE_OPS = {"sum": "SUM", "avg": "SUM", "max": "MAX", "min": "MIN",
               "product": "PRODUCT"}


def _gloo_collective(func, args, kwargs, done):
    """A functional collective over a gloo group as ``torch.distributed``'s
    synchronous one (its result registered in ``done``, whose waits are
    then no-ops); ``NotImplemented`` for another group's, or another op
    (a broadcast, an all-to-all: gloo's own way)."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    name = func.overloadpacket.__name__
    if name == "wait_tensor":
        t = args[0]
        return t if done.get(id(t)) is t else NotImplemented
    if name not in ("all_gather_into_tensor", "reduce_scatter_tensor",
                    "all_reduce", "all_gather_into_tensor_coalesced",
                    "reduce_scatter_tensor_coalesced",
                    "all_reduce_coalesced"):
        return NotImplemented
    group = kwargs.get("group_name", args[-1])
    pg = group if isinstance(group, dist.ProcessGroup) else \
        _resolve_process_group(group)
    if dist.get_backend(pg) != "gloo":
        return NotImplemented
    op = None
    if "reduce" in name:
        op = args[1]
        if op not in _REDUCE_OPS:
            return NotImplemented
    many = name.endswith("_coalesced")
    outs = []
    for x in (args[0] if many else [args[0]]):
        x = x.contiguous()
        if name.startswith("all_gather"):
            n = args[1]
            out = x.new_empty((n * x.shape[0],) + tuple(x.shape[1:]))
            dist.all_gather_into_tensor(out, x, group=pg)
        elif name.startswith("reduce_scatter"):
            n = args[2]
            out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
            dist.reduce_scatter_tensor(out, x, op=getattr(
                dist.ReduceOp, _REDUCE_OPS[op]), group=pg)
        else:
            n = dist.get_world_size(pg)
            out = x.clone()
            dist.all_reduce(out, op=getattr(dist.ReduceOp, _REDUCE_OPS[op]),
                            group=pg)
        if op == "avg":
            out = out / torch.tensor(float(n), dtype=out.dtype,
                                     device=out.device)
        done[id(out)] = out
        outs.append(out)
    return outs if many else outs[0]


def whole(t):
    """A ``DTensor`` made whole on every rank of its mesh (its
    collectives as :class:`GspmdMode` runs them); any other tensor as it
    is."""
    if not is_dtensor(t):
        return t
    with GspmdMode():
        return t.full_tensor()


def _is_dtensor_type(t) -> bool:
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


# ------------------------------ the token table -----------------------------

class _SumOver(torch.autograd.Function):
    """The sum of the ranks' tensors over ``group`` (forward); the
    gradient of the replicated sum passes through to each (backward):
    Megatron's reduction out of a vocabulary-parallel region."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist
        x = x.clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def vocab_lookup(table, tokens):
    """``table[tokens]`` for a ``DTensor`` table split over its rows (the
    vocabulary, on the model axis) and perhaps over its columns (FSDP,
    on ``data``): the columns gathered, then each rank looks its own
    tokens up in its own rows (tokens off them give 0), and the partial
    rows are summed over the vocabulary's axes.  The result keeps the
    tokens' split.  The gradient is each rank's scatter into its own
    rows, a partial sum over the axes that split the tokens, which the
    columns' gather reduce-scatters back (``DTensor``'s ``index_put``
    strategy for that gradient fails on some releases)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    mesh = table.device_mesh
    vocab_axes = _shard_axes(table, 0)
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim,
                                    run_check=False)
    tokens = tokens.redistribute(mesh, [
        Replicate() if a in vocab_axes else p
        for a, p in enumerate(tokens.placements)])
    rows = table.redistribute(mesh, [
        p if a in vocab_axes else Replicate()
        for a, p in enumerate(table.placements)])
    grad_pl = [Shard(0) if a in vocab_axes else
               Partial() if tokens.placements[a].is_shard() else Replicate()
               for a in range(mesh.ndim)]
    loc = rows.to_local(grad_placements=grad_pl)
    ids, hit = _shift(tokens.to_local(), 0, rows, local_box(rows))
    out = loc[ids.long()]
    if hit is not None:
        out = torch.where(hit[..., None], out, torch.zeros(
            (), dtype=out.dtype, device=out.device))
        for a in vocab_axes:
            out = _SumOver.apply(out, mesh.get_group(a))
    place = [p if p.is_shard() else Replicate() for p in tokens.placements]
    shape = tuple(tokens.shape) + tuple(table.shape[1:])
    return DTensor.from_local(out, mesh, place, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


__all__ = ["is_dtensor", "local_box", "gspmd_hook", "GspmdGather",
           "GspmdMode", "whole", "unregister_pointwise", "vocab_lookup"]
