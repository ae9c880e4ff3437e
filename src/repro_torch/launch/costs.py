"""Per-device cost counter of an eager program (the JAX package's
``launch/costs.py``).

JAX parses the compiled, partitioned HLO text and walks it, multiplying
each ``while`` body by its trip count.  An eager PyTorch program has no
text to parse: its layer and time loops are Python loops, so every trip
is its own run of operators.  :class:`CostCounter` is a
``TorchDispatchMode`` that sees each operator as it runs and keeps
JAX's accounting:

  * flops            — a product (``mm``, ``bmm``, ``addmm``, a
                       convolution) counts 2 x its multiply-adds; an
                       elementwise op 1 a result element; a reduction 1
                       an input element; a sort ~10 an input element;
                       views, allocations and dtype casts count 0 (JAX's
                       ``_FREE`` set and its free ``convert``);
  * bytes            — operands plus results of every op that is not
                       free: eager PyTorch writes every op's result to
                       memory, so each op is its own "fusion".  A
                       product's operands are charged at the dtype they
                       had before a cast that only fed it (JAX follows
                       ``convert`` chains the same way: the int8 product's
                       float staging copies cost nothing);
  * collectives      — the ``_c10d_functional`` ops ``DTensor`` issues
                       and the ``c10d`` ops of ``torch.distributed``, by
                       JAX's kind names, the raw result bytes as JAX's
                       ``hlo.py`` counts them and the ring-model link
                       bytes of JAX's ``_collective_link_bytes`` with the
                       group size of the process group the op names.

**Per device.**  A ``DTensor`` op seen here carries global shapes, so the
counter returns ``NotImplemented`` for it: ``DTensor`` then runs the
local ops of rank 0's shard (and the collectives its redistributions
need), which come back through the counter with local shapes.  The ops
``DTensor`` runs on fake tensors to propagate global shapes are skipped.

``dtensor_hook(counter, func, args, kwargs)``, where given, sees each
``DTensor`` op first and may run it its own way (under ``with counter``,
so what it runs is counted) or return ``NotImplemented``: the dry run's
GSPMD emulation (:func:`repro_torch.launch.dryrun.gspmd_hook`).

**Memory.**  The same run tracks live bytes by storage (a weak finalizer
on each new storage): the arguments (:meth:`CostCounter.arguments`,
named by kind), the peak of what the run allocated on top, and the
outputs (:meth:`CostCounter.outputs`) give JAX's ``memory_analysis``
keys, with a breakdown of what was live at the peak: the arguments by
kind, the activations autograd saved, the gradients (a backward's
results still live when it ends), and the temporaries.

With ``attribute=True`` every op is also charged to its call path: the
chain of ``repro_torch`` functions on the Python stack, which stands in
for JAX's ``op_name`` metadata (the port's layers are functions, not
``nn.Module`` s, so a module tracker would see none of them).
"""
from __future__ import annotations

import collections
import sys
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

#: ops that move no data and do no arithmetic: views, allocations, casts
#: (JAX counts a standalone ``convert`` free), bookkeeping
_FREE = {
    "view", "_unsafe_view", "reshape", "_reshape_alias", "expand",
    "expand_as", "permute", "transpose", "t", "select", "slice", "squeeze",
    "unsqueeze", "as_strided", "detach", "alias", "split", "split_with_sizes",
    "unbind", "chunk", "narrow", "movedim", "diagonal", "unfold", "view_as",
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
    "_to_copy", "to", "lift_fresh", "lift_fresh_copy", "_local_scalar_dense",
    "arange", "wait_tensor", "_wrap_tensor_autograd", "resize_", "set_",
    "sym_size", "sym_stride", "sym_numel", "is_same_size", "_conj", "conj",
    "real", "imag", "view_as_real", "view_as_complex", "_neg_view",
    "item", "detach_", "_unsafe_view_", "copy",
}

_PRODUCTS = {"mm", "bmm", "addmm", "baddbmm", "addbmm", "_int_mm", "dot",
             "vdot", "mv", "addmv", "_scaled_mm"}
_CONVS = {"convolution", "_convolution", "convolution_backward"}

#: reductions: 1 flop an input element (JAX's ``reduce``)
_REDUCE = {"sum", "mean", "amax", "amin", "max", "min", "prod", "logsumexp",
           "argmax", "argmin", "var", "std", "var_mean", "std_mean", "norm",
           "linalg_vector_norm", "all", "any", "cumsum", "cumprod",
           "count_nonzero", "aminmax", "nansum"}
#: softmax and its gradient, as JAX's reduce + elementwise chain
_SOFTMAX = {"_softmax": 5.0, "_log_softmax": 5.0,
            "_softmax_backward_data": 3.0, "_log_softmax_backward_data": 3.0}
_SORT = {"sort", "topk", "argsort", "kthvalue", "msort"}
#: reads a window of its input: 2 x result bytes (JAX's gather / slice)
_GATHER = {"index", "_unsafe_index", "index_select", "gather", "embedding",
           "take", "take_along_dim", "masked_select"}
#: writes an update into a buffer: 2 x update bytes (JAX's scatter /
#: dynamic-update-slice), and the update's argument position
_SCATTER = {"index_put": 2, "index_put_": 2, "_index_put_impl_": 2,
            "scatter": 3, "scatter_": 3, "scatter_add": 3, "scatter_add_": 3,
            "scatter_reduce": 3, "scatter_reduce_": 3, "index_add": 3,
            "index_add_": 3, "index_copy": 3, "index_copy_": 3,
            "select_scatter": 1, "slice_scatter": 1, "copy_": 1,
            "masked_scatter": 2, "masked_scatter_": 2,
            "embedding_dense_backward": 0}
#: data movement: operands + results, no flops (JAX's copy, concatenate,
#: pad, broadcast, transpose)
_MOVE = {"clone", "contiguous", "cat", "stack", "constant_pad_nd", "pad",
         "repeat", "repeat_interleave", "roll", "flip", "zeros", "ones",
         "full", "zeros_like", "ones_like", "full_like", "new_zeros",
         "new_ones", "new_full", "fill", "fill_", "zero_", "scalar_tensor",
         "tril", "triu", "_unsafe_split", "unsafe_split", "tensor_split",
         "index_fill", "index_fill_", "masked_fill", "masked_fill_",
         "slice_backward", "select_backward", "expand_copy"}
#: Python-operator spellings of elementwise ops (no pointwise tag)
_ELEMENTWISE = {"__or__", "__and__", "__xor__", "__ior__", "__iand__",
                "__lshift__", "__rshift__"}


#: JAX's collective kind of each ``_c10d_functional`` / ``c10d`` op
_COLLECTIVES = {
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all", "broadcast": "collective-broadcast",
    "broadcast_": "collective-broadcast",
    # c10d (``torch.distributed`` calls): the first argument is the result
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}
#: the ``_c10d_functional`` ops whose result is their return value (the
#: ``c10d`` ones write their first argument)
_FUNCTIONAL_NS = "_c10d_functional"

#: cards on one host, joined by NVLink (NVIDIA's DGX H100 reference)
HOST_CARDS = 8


class OpBudgetExceeded(RuntimeError):
    """A counted program ran over its operator budget (``max_ops``)."""


def collective_link_bytes(kind: str, raw: float, g: int) -> float:
    """JAX's ring model (``launch/costs._collective_link_bytes``): the
    bytes one rank sends over its links for a collective of ``raw``
    result bytes over a group of ``g``."""
    if g <= 1:
        return 0.0
    frac = (g - 1) / g
    if kind == "all-reduce":
        return 2.0 * raw * frac
    if kind == "collective-permute":
        return float(raw)
    return raw * frac


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _is_dtensor_type(t) -> bool:
    if not torch.distributed.is_available():
        return False
    from torch.distributed.tensor import DTensor
    return issubclass(t, DTensor)


def _local(t):
    """A ``DTensor``'s local shard (rank 0's), else ``t``."""
    return getattr(t, "_local_tensor", t)


def _group_of(name: str, args, kwargs):
    """The process group a collective names: the group name of a
    ``_c10d_functional`` op, the ``ProcessGroup`` argument of a ``c10d``
    one; None if there is none."""
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group
    vals = list(args) + list(kwargs.values())
    for v in vals:
        if isinstance(v, dist.ProcessGroup):
            return v
    for v in vals:
        if isinstance(v, str):
            try:
                return _resolve_process_group(v)
            except Exception:   # noqa: BLE001 — a reduce op's name
                continue
    return None


def _group_info(pg) -> tuple:
    """(size, whether the group lies on one host of :data:`HOST_CARDS`)."""
    import torch.distributed as dist
    if pg is None:
        return 1, True
    ranks = dist.get_process_group_ranks(pg)
    return len(ranks), len({r // HOST_CARDS for r in ranks}) == 1


def _site(func) -> str:
    """``function:aten op`` of an allocation: the innermost ``repro_torch``
    function on the stack (this module's and the dry run's excluded)."""
    name = func.overloadpacket.__name__ if func is not None else "?"
    f = sys._getframe(3)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and not fn.endswith(("costs.py",
                                                    "dryrun.py")):
            return f"{f.f_code.co_name}:{name}"
        f = f.f_back
    return name


def _call_path() -> str:
    """The ``repro_torch`` functions on the stack, outermost first (this
    module's own excluded): the op's place in the program."""
    names = []
    f = sys._getframe(2)
    while f is not None:
        fn = f.f_code.co_filename
        if "repro_torch" in fn and not fn.endswith("costs.py"):
            mod = fn.rsplit("repro_torch", 1)[1].strip("/\\")
            mod = mod[:-3] if mod.endswith(".py") else mod
            names.append(f"{mod.replace('/', '.')}.{f.f_code.co_name}")
        f = f.f_back
    return "/".join(reversed(names))


class CostCounter(TorchDispatchMode):
    """Counts the flops, bytes and collectives of the ops run under it,
    per device, and tracks their live memory (the module docstring has
    the rules).  Use as a context manager; :meth:`result` gives JAX's
    ``analyze_hlo_text`` keys and :meth:`memory` its ``memory_analysis``
    keys."""

    def __init__(self, *, attribute: bool = False, dtensor_hook=None,
                 max_ops: Optional[int] = None):
        super().__init__()
        self.max_ops = max_ops
        self.attribute = attribute
        self.dtensor_hook = dtensor_hook
        self._hooking = False
        self._depth = 0
        self.flops = 0.0
        self.bytes = 0.0
        self.raw_bytes = 0.0
        self.link_bytes = 0.0
        self.link_bytes_host = 0.0      # of collectives within one host
        self.colls: Dict[str, Dict[str, float]] = {}
        #: every collective: (kind, raw result bytes, group size)
        self.collective_log: List[tuple] = []
        self.flags: List[str] = []
        self.by_path_bytes: collections.Counter = collections.Counter()
        self.by_path_flops: collections.Counter = collections.Counter()
        # memory: storages by their C pointer
        self._t = 0
        self._src_itemsize: Dict[int, int] = {}
        self._args: Dict[int, tuple] = {}        # cdata -> (kind, bytes)
        self._read: set = set()                  # storages an op read
        self._records: Dict[int, list] = {}       # live new storages
        self._done: List[list] = []               # freed / kept records
        self._saved: set = set()
        self._live = 0
        self._peak = 0
        self._peak_t = -1
        self._bw_ends: List[int] = []
        self._in_bw = False
        self._outputs: Optional[dict] = None
        self._hooks = None

    # ----------------------------- context ---------------------------------
    def __enter__(self):
        self._depth += 1
        if self._depth == 1:
            self._hooks = torch.autograd.graph.saved_tensors_hooks(
                self._pack, lambda x: x)
            self._hooks.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        out = super().__exit__(*exc)
        self._depth -= 1
        if self._depth == 0:
            self._hooks.__exit__(*exc)
            self._end_backward()
        return out

    def _pack(self, t):
        st = _local(t).untyped_storage()
        self._saved.add(st._cdata)
        return t

    # ----------------------------- dispatch --------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        kwargs = kwargs or {}
        if any(_is_dtensor_type(t) for t in types):
            if self.dtensor_hook is not None and not self._hooking:
                self._hooking = True
                try:
                    out = self.dtensor_hook(self, func, args, kwargs)
                finally:
                    self._hooking = False
                if out is not NotImplemented:
                    return out
            return NotImplemented      # a DTensor: count its local ops
        out = func(*args, **kwargs)
        ins = _tensors(args) + _tensors(kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out                 # DTensor's global shape propagation
        self._t += 1
        if self.max_ops is not None and self._t > self.max_ops:
            raise OpBudgetExceeded(
                f"the program runs over {self.max_ops:,} operators (at "
                f"{func}); the counter's budget stops it")
        in_bw = torch._C._current_graph_task_id() != -1
        if self._in_bw and not in_bw:
            self._end_backward()
        self._in_bw = in_bw
        self._count(func, args, kwargs, ins, outs)
        self._track(outs, in_bw, func)
        if self._args:
            for t in ins:
                try:
                    self._read.add(t.untyped_storage()._cdata)
                except (RuntimeError, NotImplementedError):
                    continue
        return out

    def _count(self, func, args, kwargs, ins, outs) -> None:
        name = func.overloadpacket.__name__
        ns = func.namespace
        flops = 0.0
        nbytes = 0.0
        if name in _COLLECTIVES and ns in (_FUNCTIONAL_NS, "c10d"):
            kind = _COLLECTIVES[name]
            res = outs if ns == _FUNCTIONAL_NS else _tensors(args[0])
            raw = float(sum(_nbytes(t) for t in res))
            g, on_host = _group_info(_group_of(name, args, kwargs))
            link = collective_link_bytes(kind, raw, g)
            self.raw_bytes += raw
            self.link_bytes += link
            if on_host:
                self.link_bytes_host += link
            slot = self.colls.setdefault(kind, {"count": 0.0, "bytes": 0.0})
            slot["count"] += 1
            slot["bytes"] += raw
            self.collective_log.append((kind, raw, g))
            if self.attribute:
                self.by_path_bytes[self._tag(name)] += link
            return
        if ns == _FUNCTIONAL_NS or ns == "c10d" or name in _FREE \
                or getattr(func, "is_view", False):
            if name == "_to_copy" and ins and outs:
                self._src_itemsize[outs[0].untyped_storage()._cdata] = \
                    self._itemsize(ins[0])
            return
        in_b = float(sum(_nbytes(t) for t in ins))
        out_b = float(sum(_nbytes(t) for t in outs))
        out_n = float(sum(t.numel() for t in outs))
        if name in _PRODUCTS:
            a = args[1] if name in ("addmm", "baddbmm", "addbmm", "addmv") \
                else args[0]
            k = a.shape[-1] if a.dim() else 1
            out0 = outs[0]
            flops = 2.0 * out0.numel() * k
            srcs = [t for t in ins]
            nbytes = sum(t.numel() * self._itemsize(t) for t in srcs) + out_b
        elif name in _CONVS:
            flops, nbytes = self._conv(name, args, ins, outs), in_b + out_b
        elif name in _REDUCE:
            flops = float(ins[0].numel()) if ins else 0.0
            nbytes = in_b + out_b
        elif name in _SOFTMAX:
            flops = _SOFTMAX[name] * out_n
            nbytes = in_b + out_b
        elif name in _SORT:
            flops = 10.0 * (ins[0].numel() if ins else 0)
            nbytes = 2.0 * (in_b + out_b)
        elif name in _GATHER:
            nbytes = 2.0 * out_b + 64
        elif name in _SCATTER:
            pos = _SCATTER[name]
            upd = args[pos] if len(args) > pos else None
            upd_t = _tensors(upd)
            if name == "embedding_dense_backward":
                upd_t = _tensors(args[0])
            nu = sum(_nbytes(t) for t in upd_t)
            nbytes = 2.0 * nu + 64
            if name != "copy_":
                flops = float(sum(t.numel() for t in upd_t))
        elif name in _MOVE:
            nbytes = in_b + out_b
        elif name in _ELEMENTWISE or torch.Tag.pointwise in func.tags:
            flops = out_n
            nbytes = in_b + out_b
        else:
            nbytes = in_b + out_b
            flag = f"unknown-op:{func.namespace}.{name}"
            if flag not in self.flags:
                self.flags.append(flag)
        self.flops += flops
        self.bytes += nbytes
        if self.attribute:
            tag = self._tag(name)
            self.by_path_bytes[tag] += nbytes
            self.by_path_flops[tag] += flops

    def _tag(self, name: str) -> str:
        path = _call_path()
        return f"{path}/aten.{name}" if path else f"aten.{name}"

    def _itemsize(self, t: torch.Tensor) -> int:
        """``t``'s bytes an element before the casts that made it."""
        try:
            key = t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return t.element_size()
        return self._src_itemsize.get(key, t.element_size())

    @staticmethod
    def _conv(name, args, ins, outs) -> float:
        if name == "convolution_backward":
            grad_out, _, weight = args[0], args[1], args[2]
            mask = args[-1] if isinstance(args[-1], (list, tuple)) else \
                (True, True, True)
            per = 2.0 * grad_out.numel() * (weight.numel()
                                             // max(weight.shape[0], 1))
            return per * sum(1 for m in mask[:2] if m)
        weight = args[1]
        return 2.0 * outs[0].numel() * (weight.numel()
                                         // max(weight.shape[0], 1))

    # ----------------------------- memory ----------------------------------
    def arguments(self, named: dict) -> None:
        """Register the program's arguments, ``{kind: tree}`` (tensors or
        ``DTensor`` s, whose local shards are what a device holds)."""
        for kind, tree in named.items():
            for t in _tensors(tree):
                st = _local(t).untyped_storage()
                self._args.setdefault(st._cdata, (kind, st.nbytes()))

    def outputs(self, tree) -> None:
        """Register the program's results (after the run)."""
        new, alias, seen = 0, 0, set()
        for t in _tensors(tree):
            st = _local(t).untyped_storage()
            if st._cdata in seen:
                continue
            seen.add(st._cdata)
            if st._cdata in self._args:
                alias += st.nbytes()
            else:
                new += st.nbytes()
        self._outputs = {"new": new, "alias": alias}

    def _track(self, outs, in_bw: bool, func=None) -> None:
        for t in outs:
            try:
                st = t.untyped_storage()
            except (RuntimeError, NotImplementedError):
                continue
            key = st._cdata
            if key in self._args or key in self._records:
                continue
            n = st.nbytes()
            rec = [n, self._t, None, "backward" if in_bw else "run", key,
                   _site(func)]
            self._records[key] = rec
            self._live += n
            if self._live > self._peak:
                self._peak = self._live
                self._peak_t = self._t
            weakref.finalize(st, self._free, key)

    def _free(self, key: int) -> None:
        rec = self._records.pop(key, None)
        self._src_itemsize.pop(key, None)
        if rec is None:
            return
        # a freed storage's address may come back for a new one
        rec.append(key in self._saved)
        self._saved.discard(key)
        rec[2] = self._t + 0.5
        self._live -= rec[0]
        self._done.append(rec)

    def _end_backward(self) -> None:
        if self._in_bw:
            self._bw_ends.append(self._t)
            self._in_bw = False

    def memory(self) -> dict:
        """JAX's ``memory_analysis`` keys (per device), and
        ``breakdown``: the bytes live at the peak by kind."""
        # an argument no op reads is not the program's (XLA drops it from
        # the compiled module's parameters, as RWKV's unused decode pos)
        used = {k: v for k, v in self._args.items() if k in self._read}
        arg_bytes = sum(b for _, b in used.values())
        outs = self._outputs or {"new": 0, "alias": 0}
        t_star = self._peak_t
        by: Dict[str, float] = collections.Counter()
        for kind, b in used.values():
            by[kind] += b
        sites: Dict[str, float] = collections.Counter()
        for rec in self._done + list(self._records.values()):
            n, ta, tf, phase, key, site = rec[:6]
            if not (ta <= t_star and (tf is None or tf > t_star)):
                continue
            if (rec[6] if len(rec) > 6 else key in self._saved):
                by["activations"] += n
            elif phase == "backward":
                end = next((e for e in self._bw_ends if e >= ta), None)
                grad = tf is None or end is None or tf > end
                by["gradients" if grad else "temporaries"] += n
            else:
                by["temporaries"] += n
            sites[site] += n
        return {
            "argument_bytes": int(arg_bytes),
            "output_bytes": int(outs["new"] + outs["alias"]),
            "temp_bytes": int(max(self._peak - outs["new"], 0)),
            "alias_bytes": int(outs["alias"]),
            "peak_estimate_bytes": int(arg_bytes + self._peak),
            "breakdown": dict(by),
            # what the run allocated that was live at the peak, by the
            # function and op that allocated it (the ten largest)
            "peak_sites": dict(sites.most_common(10)),
        }

    @property
    def n_ops(self) -> int:
        """The operators counted (views and casts included)."""
        return self._t

    # ----------------------------- results ---------------------------------
    def result(self) -> dict:
        """JAX's ``analyze_hlo_text`` keys, per device; plus the link
        bytes of collectives whose group lies on one host."""
        return {
            "flops": self.flops,
            "bytes": self.bytes,
            "collective_link_bytes": self.link_bytes,
            "collective_raw_bytes": self.raw_bytes,
            "collectives": {k: dict(v) for k, v in self.colls.items()},
            "flags": list(self.flags),
            "collective_link_bytes_host": self.link_bytes_host,
        }


def count(fn, *args, attribute: bool = False, **kwargs):
    """``fn(*args, **kwargs)`` under a :class:`CostCounter`; -> (its
    result, the counter)."""
    with CostCounter(attribute=attribute) as c:
        out = fn(*args, **kwargs)
    return out, c


__all__ = ["CostCounter", "OpBudgetExceeded", "count",
           "collective_link_bytes", "HOST_CARDS"]
