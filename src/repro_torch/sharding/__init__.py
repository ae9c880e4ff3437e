"""Sharding (the JAX package's ``sharding``): logical axes and rules, the
data mesh, and the SPMD launcher that takes ``shard_map``'s place.

JAX forces N host devices into one process and ``shard_map``s a step
over them.  The port runs one process a rank instead: :func:`launch`
starts a world of N ranks once (``torch.multiprocessing``, spawned, the
rendezvous a ``FileStore`` in a temporary directory, never the network)
and runs ``fn(world, *args)`` on each.  The backend is ``gloo`` on the
CPU; on the card ``nccl`` when every rank has a device of its own, and
``gloo`` when ranks share one (NCCL refuses two ranks on one device;
gloo all-reduces CUDA tensors through the host).  A rank that fails
fails the launch: the others are stopped and the error is raised, with
nothing run again on fewer ranks.

:func:`make_data_mesh` is the one-axis ``("data",)`` mesh over some of
the world's ranks: a ``DeviceMesh`` and its process group (every rank
of the world makes each mesh, in the same order, as
``torch.distributed.new_group`` asks).  :func:`make_model_mesh` is the
``("data", "model")`` mesh (``("pod", "data", "model")`` for two pods)
with its batch and model groups, on which the tensor-parallel step
holds its state and batch as ``DTensor`` s
(:func:`distribute_tree` places a tree by its axes and the rules).
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import pickle
import tempfile
from typing import Any, Callable, Optional, Sequence

import torch

from repro_torch.sharding.logical import (Spec, constrain, input_axes,
                                          mesh_shape_of, param_axes,
                                          placements_for, placements_of,
                                          spec_for, specs_of,
                                          train_state_axes)
from repro_torch.sharding.rules import (Rules, batch_axes, serve_rules,
                                        train_rules)

#: seconds a rank waits in a collective or the rendezvous before it
#: fails (and with it the launch): a rank that died leaves no survivor
#: blocked for longer
TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class World:
    """One rank's view of a launched world."""
    rank: int
    size: int
    device: torch.device
    backend: str


def backend_for(device: torch.device, n_ranks: int) -> str:
    """``gloo`` on the CPU or when ranks share a card, else ``nccl``."""
    if device.type == "cpu":
        return "gloo"
    return "nccl" if n_ranks <= torch.cuda.device_count() else "gloo"


def rank_device(device: torch.device, rank: int) -> torch.device:
    """The device of ``rank``: the CPU, or card ``rank`` modulo the
    cards there are (ranks share cards round-robin)."""
    if device.type == "cpu":
        return device
    return torch.device("cuda", rank % torch.cuda.device_count())


def init_world(rank: int, size: int, store_path: str, device,
               timeout_s: float = TIMEOUT_S) -> World:
    """Join this process to a world of ``size`` ranks whose rendezvous
    is the ``FileStore`` at ``store_path``; -> its :class:`World`."""
    import torch.distributed as dist
    device = torch.device(device)
    dev = rank_device(device, rank)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = backend_for(device, size)
    dist.init_process_group(
        backend, store=dist.FileStore(store_path, size), rank=rank,
        world_size=size, timeout=datetime.timedelta(seconds=timeout_s))
    return World(rank, size, dev, backend)


def close_world() -> None:
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()


def _rank_main(rank: int, size: int, store_path: str, device, fn,
               args, out_path: str, timeout_s: float) -> None:
    # the ranks share the host's cores (on the card too: their steps are
    # the host's launches)
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // size))
    world = init_world(rank, size, store_path, device, timeout_s)
    try:
        result = fn(world, *args)
        if rank == 0:
            with open(out_path, "wb") as f:
                pickle.dump(result, f)
    finally:
        close_world()


def _by_name(fn: Callable) -> Callable:
    """``fn`` as its module's importable name holds it: a function of a
    module run with ``python -m`` lives in ``__main__``, which a spawned
    rank cannot import by that name."""
    import importlib
    import sys
    main = sys.modules.get("__main__")
    spec = getattr(main, "__spec__", None)
    if fn.__module__ == "__main__" and spec is not None:
        return getattr(importlib.import_module(spec.name), fn.__name__)
    return fn


def launch(fn: Callable, size: int, *, args: Sequence = (),
           device="cpu", timeout_s: float = TIMEOUT_S) -> Any:
    """Run ``fn(world, *args)`` on every rank of a world of ``size``
    ranks, launched once; -> rank 0's return value.  ``fn`` must be
    importable by name (the ranks are spawned).  Any rank's exception
    stops the others and is raised here."""
    import torch.multiprocessing as mp
    if size < 1:
        raise ValueError(f"a world needs at least one rank, not {size}")
    fn = _by_name(fn)
    with tempfile.TemporaryDirectory(prefix="repro_torch_world_") as d:
        out = os.path.join(d, "rank0.pkl")
        mp.start_processes(
            _rank_main, args=(size, os.path.join(d, "store"), str(device),
                              fn, tuple(args), out, timeout_s),
            nprocs=size, join=True, start_method="spawn")
        with open(out, "rb") as f:
            return pickle.load(f)


@dataclasses.dataclass
class DataMesh:
    """A one-axis ``("data",)`` mesh: its ranks (of the world), the
    ``DeviceMesh`` and the process group; ``group`` is None on a rank
    outside the mesh."""
    ranks: tuple
    device_mesh: Any
    group: Any

    @property
    def size(self) -> int:
        return len(self.ranks)

    @property
    def member(self) -> bool:
        return self.group is not None

    @property
    def rank(self) -> int:
        """This rank's index in the mesh (its shard)."""
        import torch.distributed as dist
        return self.ranks.index(dist.get_rank())


def make_data_mesh(n_shards: int, ranks: Optional[Sequence[int]] = None,
                   device_type: Optional[str] = None) -> DataMesh:
    """The ``("data",)`` mesh of ``n_shards`` ranks of the current world
    (``ranks``: an explicit slice, as the campaign places cells; default
    the world's first).  Every rank of the world calls it."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh
    world = dist.get_world_size()
    ranks = tuple(range(n_shards)) if ranks is None else tuple(ranks)
    if len(ranks) != n_shards or world < n_shards:
        raise ValueError(
            f"a data mesh of {n_shards} shards needs {n_shards} ranks but "
            f"the world has {world} (ranks {ranks})")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = DeviceMesh(device_type, torch.tensor(ranks),
                      mesh_dim_names=("data",))
    group = mesh.get_group("data") if dist.get_rank() in ranks else None
    return DataMesh(ranks, mesh, group)


@dataclasses.dataclass
class ModelMesh:
    """A mesh with a model axis: ``("data", "model")``, or ``("pod",
    "data", "model")``; the ``DeviceMesh``, the group of the ranks that
    split the batch (``pod`` x ``data``, one model coordinate) and the
    model axis's group (None on a rank outside the mesh)."""
    device_mesh: Any
    batch_group: Any
    model_group: Any

    @property
    def shape(self) -> tuple:
        return tuple(self.device_mesh.shape)

    @property
    def axes(self) -> tuple:
        return tuple(self.device_mesh.mesh_dim_names)

    @property
    def n_batch(self) -> int:
        """The batch's shards: the product of every axis but ``model``."""
        n = 1
        for a, s in zip(self.axes, self.shape):
            if a != "model":
                n *= s
        return n

    @property
    def batch_rank(self) -> int:
        """This rank's shard of the batch (its ``pod``, ``data``
        coordinate, row-major)."""
        coord = self.device_mesh.get_coordinate()
        i = 0
        for a, s, c in zip(self.axes, self.shape, coord):
            if a != "model":
                i = i * s + c
        return i

    @property
    def multi_pod(self) -> bool:
        return "pod" in self.axes


def make_model_mesh(shape: Sequence[int], ranks: Optional[Sequence[int]]
                    = None, device_type: Optional[str] = None) -> ModelMesh:
    """The ``("data", "model")`` mesh of ``shape`` (three dimensions:
    ``("pod", "data", "model")``) over ranks of the current world
    (``ranks``, default its first), with its groups.  Every rank of the
    world calls it."""
    import logging

    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    # DTensor's advice on sequential all-reduces (a 2-D mesh's partial
    # sums) and the CPU group's all-to-all fallback: known, not faults
    for name in ("torch.distributed.tensor._redistribute",
                 "torch._logging._internal"):
        logging.getLogger(name).setLevel(logging.ERROR)
    shape = tuple(int(s) for s in shape)
    if len(shape) not in (2, 3):
        raise ValueError(f"a model mesh is 2-D or 3-D, not {shape}")
    axes = ("pod", "data", "model") if len(shape) == 3 else ("data", "model")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    mesh = make_host_mesh(shape, axes, ranks=ranks, device_type=device_type)
    member = mesh.get_coordinate() is not None
    if len(shape) == 2:
        return ModelMesh(mesh, mesh.get_group("data") if member else None,
                         mesh.get_group("model") if member else None)
    # the pod x data groups, one a model coordinate: every rank makes each
    grid = mesh.mesh.reshape(-1, shape[-1]).tolist()
    batch_group = None
    for m in range(shape[-1]):
        members = [row[m] for row in grid]
        g = dist.new_group(members)
        if dist.get_rank() in members:
            batch_group = g
    return ModelMesh(mesh, batch_group,
                     mesh.get_group("model") if member else None)


def distribute(t: torch.Tensor, device_mesh, placements, device=None):
    """``t`` (the whole tensor, on any device) as the ``DTensor`` of
    ``placements``: this rank's block cut out and copied to ``device``
    (default ``t``'s), no collective."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import \
        compute_local_shape_and_global_offset
    shape, offset = compute_local_shape_and_global_offset(
        t.shape, device_mesh, placements)
    loc = t
    for d, (n, o) in enumerate(zip(shape, offset)):
        if n != t.shape[d]:
            loc = loc.narrow(d, o, n)
    loc = loc.to(device or t.device, copy=True).contiguous()
    return DTensor.from_local(loc, device_mesh, placements, run_check=False,
                              shape=t.shape, stride=t.stride())


def distribute_tree(tree, axes, rules, device_mesh, device=None):
    """A tensor tree as ``DTensor`` s by its axes tree and ``rules``: each
    rank's blocks (:func:`repro_torch.runtime.elastic.remesh_state`'s
    cut), on ``device``, under the placements of :func:`placements_of`."""
    from torch.distributed.tensor import DTensor

    from repro_torch.runtime.elastic import remesh_state
    from repro_torch.sharding.logical import _map_axes
    blocks = remesh_state(tree, axes, rules, device_mesh, device)
    names = tuple(device_mesh.mesh_dim_names)
    ms = mesh_shape_of(device_mesh)
    return _map_axes(lambda ax, t, b: DTensor.from_local(
        b.contiguous(), device_mesh,
        placements_for(spec_for(tuple(t.shape), ax, rules, ms), names),
        run_check=False, shape=t.shape, stride=t.stride()),
        axes, tree, blocks)


def full_tree(tree):
    """A tree's ``DTensor`` leaves made whole (a collective each, every
    rank alike), other leaves as they are."""
    from repro_torch.core.tree import tree_map
    from repro_torch.sharding.gspmd import whole
    return tree_map(whole, tree)


__all__ = [
    "ModelMesh", "make_model_mesh", "distribute", "distribute_tree",
    "full_tree", "Spec", "spec_for", "mesh_shape_of", "specs_of", "placements_for",
    "placements_of", "constrain", "param_axes", "train_state_axes",
    "input_axes", "Rules", "train_rules", "serve_rules", "batch_axes",
    "TIMEOUT_S", "World", "backend_for", "rank_device", "init_world",
    "close_world", "launch", "DataMesh", "make_data_mesh",
]
