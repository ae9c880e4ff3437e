"""Logical-axis sharding (the JAX package's ``sharding/logical.py``).

Every parameter, cache buffer and input dimension has a *logical* axis
name.  JAX carries them on the leaves (``LogicalParam``); the port's
tensors carry none, so the names live in an **axes tree** shaped like
the tensor tree, one tuple of names per leaf: :func:`param_axes` derives
a parameter tree's from its leaf paths (the JAX layers' own ``param``
calls, by path), :func:`train_state_axes` a training state's and
:func:`input_axes` a batch's.

A rule set (:mod:`repro_torch.sharding.rules`) maps logical names to
mesh axes per run mode.  :func:`spec_for` derives one tensor's spec as
JAX does, shape-aware: a mesh axis that does not divide the dimension,
or that an earlier dimension of the same tensor already took, falls
back to replication.  A spec is a plain tuple (JAX's ``PartitionSpec``
entries, trailing ``None`` trimmed); :func:`placements_of` turns specs
into ``torch.distributed.tensor`` placements on a ``DeviceMesh``.

The port runs data meshes and model meshes on real ranks: on a model
mesh (ROADMAP A8.4) the train step's state and batch are ``DTensor`` s
placed by :func:`placements_of`, and :func:`constrain` redistributes
activations as JAX's constraints do, as it does on the dry run's meta
``DTensor`` s (:mod:`repro_torch.launch.dryrun`).
"""
from __future__ import annotations

from typing import Any, Optional, Sequence, Tuple

Spec = Tuple[Any, ...]


# ------------------------------ specs --------------------------------------

def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             rules: dict, mesh_shape: dict) -> Spec:
    """The spec of one tensor: per dimension the mesh axis (or tuple of
    axes, or None) its logical axis maps to, if the mesh axes divide it
    and no earlier dimension used them; trailing Nones trimmed."""
    used: set = set()
    parts = []
    for dim, name in zip(shape, axes):
        mapped = rules.get(name) if name is not None else None
        if mapped is None:
            parts.append(None)
            continue
        mesh_axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        mesh_axes = tuple(a for a in mesh_axes
                          if a not in used and a in mesh_shape)
        size = 1
        keep = []
        for a in mesh_axes:
            if dim % (size * mesh_shape[a]) == 0:
                keep.append(a)
                size *= mesh_shape[a]
        if not keep:
            parts.append(None)
        else:
            used.update(keep)
            parts.append(tuple(keep) if len(keep) > 1 else keep[0])
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def mesh_shape_of(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` (or of a dict, as is)."""
    if isinstance(mesh, dict):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str)
                                        for a in x)


def _map_axes(fn, axes_tree, *rest):
    """``fn`` over an axes tree's leaves (tuples of names) and the
    corresponding leaves of ``rest``."""
    if _is_axes(axes_tree):
        return fn(axes_tree, *rest)
    if isinstance(axes_tree, dict):
        return {k: _map_axes(fn, v, *(r[k] for r in rest))
                for k, v in axes_tree.items()}
    if isinstance(axes_tree, (list, tuple)):
        out = [_map_axes(fn, v, *(r[i] for r in rest))
               for i, v in enumerate(axes_tree)]
        if hasattr(axes_tree, "_fields"):
            return type(axes_tree)(*out)
        return type(axes_tree)(out)
    raise TypeError(f"not an axes tree node: {axes_tree!r}")


def specs_of(axes_tree, shapes_tree, rules: dict, mesh) -> Any:
    """The spec tree of a tensor tree: :func:`spec_for` of each leaf's
    shape (a tensor, a meta tensor or a ``TensorSpec``) and axes on the
    mesh (a ``DeviceMesh`` or a ``{axis: size}`` dict)."""
    ms = mesh_shape_of(mesh)
    return _map_axes(lambda ax, t: spec_for(tuple(t.shape), ax, rules, ms),
                     axes_tree, shapes_tree)


def placements_for(spec: Spec, mesh_dim_names: Sequence[str]) -> tuple:
    """One spec as ``torch.distributed.tensor`` placements, one per mesh
    dimension: ``Shard(d)`` where tensor dimension ``d`` is split over it,
    ``Replicate()`` elsewhere."""
    from torch.distributed.tensor import Replicate, Shard
    by_axis = {}
    for d, part in enumerate(spec):
        for a in (() if part is None else
                  (part,) if isinstance(part, str) else part):
            by_axis[a] = d
    return tuple(Shard(by_axis[a]) if a in by_axis else Replicate()
                 for a in mesh_dim_names)


def placements_of(axes_tree, shapes_tree, rules: dict, device_mesh) -> Any:
    """The placement tree of a tensor tree on ``device_mesh``."""
    names = tuple(device_mesh.mesh_dim_names)
    ms = mesh_shape_of(device_mesh)
    # per leaf: a spec holds tuples of mesh axes, not an axes tree
    return _map_axes(lambda ax, t: placements_for(
        spec_for(tuple(t.shape), ax, rules, ms), names), axes_tree,
        shapes_tree)


def constrain(x, axes: Sequence[Optional[str]], rules: Optional[dict],
              mesh=None):
    """JAX's ``with_sharding_constraint`` by logical axes.  A ``DTensor``
    is redistributed, on its own mesh, to the placements of
    :func:`spec_for` of its global shape (so no ambient mesh is needed).
    A plain tensor is local to its rank and returned as is: on one
    device, on a data mesh (each rank's rows), and on a model mesh,
    whose every tensor on the step's path is a ``DTensor``.  ``mesh`` is
    JAX's argument, which the port needs not."""
    del mesh
    if rules is None:
        return x
    device_mesh = getattr(x, "device_mesh", None)
    if device_mesh is None:
        return x
    spec = spec_for(tuple(x.shape), axes, rules, mesh_shape_of(device_mesh))
    want = placements_for(spec, tuple(device_mesh.mesh_dim_names))
    if tuple(x.placements) == want:
        return x
    return x.redistribute(device_mesh, want)


# ------------------------------ axes trees ----------------------------------

#: (input axis, output axis) of each linear by its name, and by its
#: parent's name where one name means two layouts (RWKV's channel mix
#: ``cm.wk`` / ``cm.wv`` are an FFN's up and down)
_LINEAR = {
    "wq": ("embed", "heads_x"), "wk": ("embed", "heads_x"),
    "wv": ("embed", "heads_x"), "wr": ("embed", "heads_x"),
    "wg": ("embed", "heads_x"), "wo": ("heads_x", "embed"),
    "gate": ("embed", "mlp"), "up": ("embed", "mlp"),
    "in_proj": ("embed", "mlp"), "down": ("mlp_in", "embed"),
    "out_proj": ("mlp_in", "embed"), "x_proj": ("mlp_in", None),
    "dt_proj": (None, "mlp"), "lm_head": ("embed", "vocab"),
    "head": ("embed", "vocab"), "fc1": ("frontend", "embed"),
    "fc2": ("embed", "embed2"), "router": ("embed", None),
}
_LINEAR_IN = {("cm", "wk"): ("embed", "mlp"),
              ("cm", "wv"): ("mlp_in", "embed")}
#: a MoE's expert stacks: (float w, packed w, per-column vectors)
_EXPERT = {
    "gate": (("expert", "embed", "expert_mlp"),
             ("expert", "embed", "expert_mlp"), ("expert", "expert_mlp")),
    "up": (("expert", "embed", "expert_mlp"),
           ("expert", "embed", "expert_mlp"), ("expert", "expert_mlp")),
    "down": (("expert", "expert_mlp", "embed"),
             ("expert", "embed", "expert_mlp"), ("expert", "expert_mlp")),
}
#: leaves that are not a linear's, by (parent, name) or by name
_NAMED = {
    ("embed", "table"): ("vocab", "embed"),
    ("embed", "alphas"): ("vocab",), ("embed", "betas"): ("vocab",),
    ("embed", "rowsums"): ("vocab",),
    ("q_norm", "scale"): (None,), ("k_norm", "scale"): (None,),
    ("tm", "mu"): (None, "embed"), ("cm", "mu"): (None, "embed"),
    ("tm", "w0"): ("embed",), ("tm", "w_lora_a"): ("embed", None),
    ("tm", "w_lora_b"): (None, "embed"), ("tm", "bonus"): (None, None),
    ("ssm", "a_log"): ("mlp", None), ("ssm", "conv_w"): (None, "mlp"),
    ("ssm", "d_skip"): ("mlp",),
    "meta": (None, "embed"), "pos": (None, "embed"),
    "scale": ("embed",), "bias": ("embed",),
}


def _leaf_axes(path: Tuple[str, ...]) -> Tuple[Optional[str], ...]:
    name = path[-1]
    parent = path[-2] if len(path) > 1 else None
    grand = path[-3] if len(path) > 2 else None
    if grand == "moe" and parent in _EXPERT:
        w, packed, col = _EXPERT[parent]
        axes = {"w": w, "w_packed": packed, "alpha": col,
                "colsum": col}[name]
    elif parent in _LINEAR and name in ("w", "w_packed", "b", "alpha",
                                        "colsum"):
        in_ax, out_ax = _LINEAR_IN.get((grand, parent), _LINEAR[parent])
        axes = (in_ax, out_ax) if name in ("w", "w_packed") else (out_ax,)
    elif (parent, name) in _NAMED:
        axes = _NAMED[parent, name]
    elif name in _NAMED:
        axes = _NAMED[name]
    else:
        raise KeyError(f"no logical axes for the leaf {'.'.join(path)}")
    return (("layers",) if "layers" in path[:-1] else ()) + tuple(axes)


def param_axes(params) -> Any:
    """The axes tree of a parameter tree (float or int8 serving form, any
    family of :class:`repro_torch.models.base.Model`): JAX's
    ``LogicalParam`` axes of each leaf, by its path; a leaf under a layer
    stack leads with ``"layers"``."""
    def rec(node, path):
        if isinstance(node, dict):
            return {k: rec(v, path + (k,)) for k, v in node.items()}
        return _leaf_axes(path)
    return rec(params, ())


def train_state_axes(params, *, compress: bool = False) -> dict:
    """The axes tree of :func:`repro_torch.launch.steps.init_train_state`
    (JAX's ``train_state_lp``): the moments carry their parameter's axes
    (ZeRO falls out of the FSDP rules), a frozen leaf's zero-size moment
    ``(None,)``, the counters ``()``; with ``compress`` the residuals
    carry their parameter's axes."""
    from repro_torch.optim import is_trainable
    from repro_torch.runtime.compression import CompressionState
    p_axes = param_axes(params)
    mom = _map_axes(lambda ax, p: ax if is_trainable(p) else (None,),
                    p_axes, params)
    state = {"params": p_axes, "opt": {"m": mom, "v": mom, "count": ()},
             "step": ()}
    if compress:
        state["comm"] = CompressionState(error=p_axes)
    return state


#: a serving cache's leaves by (parent, name): JAX's ``init_*_cache``
#: axes (the leading layer axis, which no rule maps, first)
_CACHE = {
    ("attn", "k"): ("layers", "batch", None, "kv_seq", None),
    ("attn", "v"): ("layers", "batch", None, "kv_seq", None),
    ("self", "k"): ("layers", "batch", None, "kv_seq", None),
    ("self", "v"): ("layers", "batch", None, "kv_seq", None),
    ("cross", "k"): ("layers", "batch", None, None, None),
    ("cross", "v"): ("layers", "batch", None, None, None),
    ("ssm", "conv"): ("layers", "batch", None, "mlp"),
    ("ssm", "h"): ("layers", "batch", "mlp", None),
    (None, "S"): ("layers", "batch", "heads_x", None, None),
    (None, "x_tm"): ("layers", "batch", None),
    (None, "x_cm"): ("layers", "batch", None),
}


def cache_axes(cache) -> Any:
    """The axes tree of a serving cache (``Model.init_cache``): the LM
    and hybrid caches, whisper's self and cross caches, RWKV's state."""
    def rec(node, parent, name):
        if isinstance(node, dict):
            return {k: rec(v, name, k) for k, v in node.items()}
        return _CACHE[parent, name]
    return rec(cache, None, None)


def input_axes(specs: dict) -> dict:
    """The axes tree of a batch (``Model.input_specs``): the batch axis
    first, every other dimension unsharded."""
    return {k: ("batch",) + (None,) * (len(s.shape) - 1)
            for k, s in specs.items()}


def tree_of_specs_leaves(tree) -> list:
    """The leaves of a spec (or axes) tree, in the JAX flatten order."""
    out = []

    def rec(node):
        if _is_axes(node):
            out.append(node)
        elif isinstance(node, dict):
            for k in sorted(node):
                rec(node[k])
        else:
            for v in node:
                rec(v)
    rec(tree)
    return out


__all__ = ["Spec", "spec_for", "mesh_shape_of", "specs_of",
           "placements_for", "placements_of", "constrain", "param_axes",
           "train_state_axes", "cache_axes", "input_axes",
           "tree_of_specs_leaves"]
