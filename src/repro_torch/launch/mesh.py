"""Mesh constructors (the JAX package's ``launch/mesh.py``) over the ranks of
the current ``torch.distributed`` world: a rank takes the place of a
JAX device.  Functions, so importing this module touches no process
group."""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np


def _world_size() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_initialized() else 1


def production_shape(multi_pod: bool = False) -> tuple:
    """(16, 16) = ("data", "model") for one pod, (2, 16, 16) = ("pod",
    "data", "model") for the two-pod, 512-rank configuration."""
    return ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))


def production_grid(multi_pod: bool = False,
                    world_size: Optional[int] = None) -> np.ndarray:
    """The production mesh's ranks, laid out in its shape.  A world
    smaller than 256 (512) ranks raises JAX's error on a host:
    ``cannot reshape array of size N into shape (16,16)``."""
    shape, _ = production_shape(multi_pod)
    world = _world_size() if world_size is None else world_size
    return np.arange(world)[:int(np.prod(shape))].reshape(shape)


def make_production_mesh(*, multi_pod: bool = False,
                         world_size: Optional[int] = None,
                         device_type: str = "cuda"):
    """The production ``DeviceMesh`` over a world of 256 (or 512) ranks
    (:func:`production_grid`'s error on a smaller one)."""
    _, axes = production_shape(multi_pod)
    grid = production_grid(multi_pod, world_size)
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.from_numpy(grid),
                      mesh_dim_names=axes)


def check_host_world(shape, available: int) -> None:
    """JAX's error when a host mesh asks for more devices (here ranks)
    than there are, with the port's remedy."""
    n = int(np.prod(shape))
    if available < n:
        raise ValueError(
            f"mesh shape {tuple(shape)} needs {n} devices but only "
            f"{available} are available (launch more ranks: "
            f"--device-count N)")


def make_host_mesh(shape=(1, 1), axes=("data", "model"),
                   ranks: Optional[Sequence[int]] = None,
                   device_type: str = "cpu"):
    """A small ``DeviceMesh`` over ranks of the current world (tests, the
    train CLI's ``--mesh host``, campaign cells): ``ranks`` picks an
    explicit slice, by default the world's first.  Asking for more ranks
    than the world has is JAX's error, with the port's remedy."""
    n = int(np.prod(shape))
    pool = list(ranks) if ranks is not None else list(range(_world_size()))
    check_host_world(shape, len(pool))
    import torch
    from torch.distributed.device_mesh import DeviceMesh
    grid = torch.tensor(pool[:n]).reshape(tuple(shape))
    return DeviceMesh(device_type, grid, mesh_dim_names=tuple(axes))


__all__ = ["production_shape", "production_grid", "make_production_mesh",
           "check_host_world", "make_host_mesh"]
