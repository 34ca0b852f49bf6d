"""Device meshes of the port — the counterpart of the JAX package's
``launch/mesh.py`` for one-process-per-shard PyTorch.

A JAX mesh is one controller's grid of devices.  The port runs one
process per grid cell (SPMD, ``torch.distributed``), so its mesh is the
``(data, model)`` grid of ``torch.device`` (as
``cluster/meshbridge.py::DeviceMesh``) plus what the calling process needs
to take part: its coordinates in the grid, the process group of its
``model`` row, and a gloo group over that row for host-side collectives
on CPU tensors (barriers, the serving lockstep checks).  Groups along
``data`` wait for the training side of the port.

Nothing is chosen behind the caller's back: a mesh of more than one cell
needs ``torch.distributed`` initialised over exactly its cells, the
devices named one per cell, and the backend named.  NCCL takes one rank
per card; ranks that share a card use gloo.  The pod-shaped production
meshes of the JAX package wait for the training side of the port.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("data", "model")


@dataclass(frozen=True)
class Mesh:
    """A ``(data, model)`` grid of ``torch.device`` seen from one process."""
    devices: np.ndarray                 # (data, model) object array
    coords: tuple                       # this process's (data, model) cell
    groups: dict = field(default_factory=dict)   # axis -> process group
    cpu_group: object = None            # gloo over this process's model row
    backend: Optional[str] = None
    axis_names: tuple = AXES

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.devices.shape))

    @property
    def rank(self) -> int:
        """This process's cell, row-major (its ``torch.distributed``
        rank)."""
        return self.coords[0] * self.devices.shape[1] + self.coords[1]

    @property
    def device(self) -> torch.device:
        return self.devices[self.coords]

    def group(self, axis: str):
        """The process group of ``axis`` through this cell (None where
        the mesh has none: an axis of size 1, or ``data``)."""
        return self.groups.get(axis)

    def model_ranks(self) -> list:
        """The ranks of this cell's ``model`` row, in axis order."""
        n_model = self.devices.shape[1]
        return [self.coords[0] * n_model + j for j in range(n_model)]


def make_mesh(data: int = 1, model: int = 1, *, devices=None,
              backend: Optional[str] = None) -> Mesh:
    """The ``(data, model)`` mesh of the calling process.

    One cell: ``devices`` defaults to the card (``resolve_device``), no
    process group.  More cells: ``torch.distributed`` must be initialised
    with world size ``data * model`` (rank r is cell ``divmod(r,
    model)``), ``devices`` names one device per cell, row-major, and
    ``backend`` the groups' backend; every rank calls this in the same
    order, since it creates the groups."""
    n = data * model
    if n < 1:
        raise ValueError(f"make_mesh: data {data} x model {model} cells")
    if n == 1:
        dev = resolve_device(None if devices is None else list(devices)[0])
        grid = np.empty((1, 1), dtype=object)
        grid[0, 0] = dev
        return Mesh(devices=grid, coords=(0, 0), backend=backend)
    if devices is None or backend is None:
        raise ValueError(f"make_mesh: a mesh of {n} cells needs its devices "
                         "and its backend named (devices=, backend=)")
    devices = [torch.device(d) for d in devices]
    if len(devices) != n:
        raise ValueError(f"make_mesh: {len(devices)} devices for {n} cells")
    if backend == "nccl" and len(set(map(str, devices))) != n:
        raise ValueError("make_mesh: NCCL takes one rank per card; ranks "
                         "that share a card use backend='gloo'")
    if not dist.is_initialized() or dist.get_world_size() != n:
        raise RuntimeError(f"make_mesh: torch.distributed must be "
                           f"initialised with world size {n} first")
    rank = dist.get_rank()
    grid = np.empty(n, dtype=object)
    grid[:] = devices
    grid = grid.reshape(data, model)
    coords = divmod(rank, model)
    groups, cpu_group = {}, None
    # new_group is collective: every rank creates every row's groups, in
    # order.  Only the model axis gets one: serving TP reduces over it
    for d in range(data if model > 1 else 0):
        ranks = [d * model + j for j in range(model)]
        g = dist.new_group(ranks, backend=backend)
        c = g if backend == "gloo" else dist.new_group(ranks,
                                                        backend="gloo")
        if rank in ranks:
            groups["model"], cpu_group = g, c
    return Mesh(devices=grid, coords=coords, groups=groups,
                cpu_group=cpu_group, backend=backend)


def single_device_mesh(device=None) -> Mesh:
    return make_mesh(1, 1, devices=None if device is None else [device])
