"""Elastic re-mesh (the JAX package's ``runtime/elastic.py``): shrink or
grow the data axis and re-place live state.

A rank dies -> the job restarts on the N-k that survive.  The *model*
axes keep their size (tensor-parallel shardings bake into the weights'
divisibility); the *data* (and pod) axes are elastic.  :func:`plan_remesh`
computes the largest valid data axis for the surviving count;
:func:`remesh_state` re-places a state (from a checkpoint restore) on the
new mesh with the blocks re-derived from the same logical rules.

The batch contract: the global batch stays fixed (each replica's share
grows), so training dynamics and the data stream (seeded by step) are
unchanged.

A checkpoint of a data-parallel world holds rank 0's full copy (every
rank holds the replicated state; ZeRO-1's flat shards are gathered into
it first, :func:`repro_torch.launch.steps.zero1_full_state`): a restore
onto any world reads that copy and :func:`remesh_state` cuts each rank's
blocks from it.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

#: the logical axis of ZeRO-1's flat float32 vectors (master weights and
#: moments): padded to a multiple of the data axis, then cut in equal
#: blocks, one a rank
FLAT = "flat"


@dataclasses.dataclass(frozen=True)
class RemeshPlan:
    old_shape: tuple
    new_shape: tuple
    axes: tuple
    dropped_devices: int

    @property
    def data_parallel(self) -> int:
        sizes = dict(zip(self.axes, self.new_shape))
        return sizes.get("data", 1) * sizes.get("pod", 1)


def plan_remesh(n_devices: int, *, model_parallel: int = 16,
                axes=("data", "model"),
                old_shape: Optional[tuple] = None) -> RemeshPlan:
    """Largest (data, model) mesh with a fixed model axis that fits
    ``n_devices``.  Raises if fewer than one model group survives."""
    if n_devices < model_parallel:
        raise ValueError(
            f"{n_devices} devices cannot host model_parallel="
            f"{model_parallel}; a standby pool or smaller TP is required")
    data = n_devices // model_parallel
    new_shape = (data, model_parallel)
    used = data * model_parallel
    return RemeshPlan(old_shape or new_shape, new_shape, tuple(axes),
                      n_devices - used)


def make_mesh_from_plan(plan: RemeshPlan, device_type: str = "cpu"):
    """The plan's ``DeviceMesh`` over the world's first ranks."""
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh(plan.new_shape, plan.axes,
                          device_type=device_type)


def _mesh_coords(mesh) -> dict:
    """``{axis: (size, this rank's index)}`` of a ``DeviceMesh`` or a
    :class:`repro_torch.sharding.DataMesh`."""
    if hasattr(mesh, "ranks"):                      # a DataMesh
        return {"data": (mesh.size, mesh.rank)}
    coords = mesh.get_coordinate()
    return {a: (s, c) for a, s, c in zip(mesh.mesh_dim_names, mesh.shape,
                                          coords)}


def flat_block(full: torch.Tensor, n: int, i: int) -> torch.Tensor:
    """Block ``i`` of ``n`` of a flat vector padded with zeros to a
    multiple of ``n`` (ZeRO-1's layout)."""
    pad = (-full.numel()) % n
    if pad:
        full = torch.cat([full, full.new_zeros(pad)])
    size = full.numel() // n
    return full[i * size:(i + 1) * size].clone()


def remesh_state(state, axes_tree, rules: dict, mesh, device=None):
    """Re-place ``state`` (a full copy, as a restore reads it) on
    ``mesh``: each leaf's block for this rank by its spec under
    ``rules`` (:func:`repro_torch.sharding.spec_for`; a dimension split
    over mesh axes is cut in equal blocks), on ``device`` (default: each
    leaf's own).  Under rules that shard nothing on a data mesh (the
    port's data parallelism, ``serve_rules``) this is the replicated
    state; a :data:`FLAT` leaf is ZeRO-1's vector, re-cut for the new
    data axis."""
    from repro_torch.sharding.logical import _map_axes, spec_for
    coords = _mesh_coords(mesh)
    sizes = {a: s for a, (s, _) in coords.items()}

    def place(axes, leaf):
        out = leaf
        if axes == (FLAT,):
            n, i = coords.get("data", (1, 0))
            out = flat_block(leaf.reshape(-1), n, i)
        else:
            for d, part in enumerate(spec_for(tuple(leaf.shape), axes,
                                              rules, sizes)):
                if part is None:
                    continue
                n, i = 1, 0
                for a in ((part,) if isinstance(part, str) else part):
                    s, c = coords[a]
                    n, i = n * s, i * s + c
                out = torch.chunk(out, n, dim=d)[i]
            out = out.clone() if out is not leaf else out
        return out.to(device) if device is not None else out

    return _map_axes(place, axes_tree, state)


__all__ = ["FLAT", "RemeshPlan", "plan_remesh", "make_mesh_from_plan",
           "flat_block", "remesh_state"]
