"""Device meshes of the port — the counterpart of the JAX package's
``launch/mesh.py`` for one-process-per-cell PyTorch.

A JAX mesh is one controller's grid of devices.  The port runs one
process per grid cell (SPMD, ``torch.distributed``), so its mesh is the
``(data, model)`` grid of ``torch.device`` (as
``cluster/meshbridge.py::DeviceMesh``) plus what the calling process needs
to take part: its coordinates in the grid, the process group of its
``model`` row and of its ``data`` column, and a gloo group over the row
for host-side collectives on CPU tensors (barriers, the serving lockstep
checks).  :func:`launch_ranks` starts the processes.

Nothing is chosen behind the caller's back: a mesh of more than one cell
needs ``torch.distributed`` initialised over exactly its cells, the
devices named one per cell, and the backend named.  NCCL takes one rank
per card; ranks that share a card use gloo.

The JAX package's production meshes (:func:`make_production_mesh`, 16 x
16 cells, or 2 x 16 x 16 with a leading ``pod`` axis) serve its dry run
(``launch.dryrun``): the port builds them inside a :func:`virtual_world`,
the fake backend over every cell, where this process is one rank whose
devices are ``meta``.
"""
from __future__ import annotations

import contextlib
import itertools
import multiprocessing as mp
import os
import queue
import shutil
import tempfile
import time
import traceback
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

AXES = ("data", "model")
#: the production meshes of the JAX package: one pod of 16 x 16 cells, and
#: two pods joined on a leading ``pod`` axis
PRODUCTION_SHAPES = {False: ((16, 16), AXES),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


@dataclass(frozen=True)
class Mesh:
    """A grid of ``torch.device`` seen from one process: ``(data,
    model)``, or ``(pod, data, model)`` for the multi-pod production mesh
    (:func:`make_production_mesh`)."""
    devices: np.ndarray                 # object array, a dim an axis
    coords: tuple                       # this process's cell
    groups: dict = field(default_factory=dict)   # axis (or axes) -> group
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
        return int(np.ravel_multi_index(self.coords, self.devices.shape))

    @property
    def device(self) -> torch.device:
        return self.devices[self.coords]

    def group(self, axis):
        """The process group of ``axis`` through this cell: one axis name,
        or a tuple of names for the cells that differ along those axes
        (``("pod", "data")``, the batch of a multi-pod mesh).  None where
        the mesh has none: an axis of size 1."""
        return self.groups.get(axis)

    def model_ranks(self) -> list:
        """The ranks of this cell's ``model`` row, in axis order."""
        return _axis_ranks(self.devices.shape, self.coords,
                           (len(self.axis_names) - 1,))


def _axis_ranks(shape: tuple, coords: tuple, dims: tuple) -> list:
    """The ranks of the cells that share ``coords`` outside ``dims``,
    row-major."""
    sub = [range(shape[d]) if d in dims else [coords[d]]
           for d in range(len(shape))]
    return sorted(int(np.ravel_multi_index(c, shape))
                  for c in itertools.product(*sub))


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
    # new_group is collective: every rank creates every group, in the same
    # order.  The model rows first (serving TP reduces over them), then
    # the data columns (training's gradient reductions and ZeRO gathers)
    for d in range(data if model > 1 else 0):
        ranks = [d * model + j for j in range(model)]
        g = dist.new_group(ranks, backend=backend)
        c = g if backend == "gloo" else dist.new_group(ranks,
                                                        backend="gloo")
        if rank in ranks:
            groups["model"], cpu_group = g, c
    for j in range(model if data > 1 else 0):
        ranks = [d * model + j for d in range(data)]
        g = dist.new_group(ranks, backend=backend)
        if rank in ranks:
            groups["data"] = g
    return Mesh(devices=grid, coords=coords, groups=groups,
                cpu_group=cpu_group, backend=backend)


def virtual_mesh(shape: tuple, axis_names: tuple = AXES) -> Mesh:
    """The mesh of this process's rank in a ``virtual_world``: cells on
    the ``meta`` device, the groups of the axes through the cell (and of
    ``("pod", "data")`` on a pod mesh) on the fake backend, no gloo group
    (a gloo group over a fake world would wait for peers that never
    come).  The world must hold exactly the mesh's cells."""
    n = int(np.prod(shape))
    if not dist.is_initialized() or dist.get_world_size() != n \
            or dist.get_backend() != "fake":
        raise RuntimeError(f"virtual_mesh: needs a virtual_world of {n} "
                           "ranks")
    grid = np.empty(n, dtype=object)
    grid[:] = [torch.device("meta")] * n
    grid = grid.reshape(shape)
    coords = tuple(int(c) for c in np.unravel_index(dist.get_rank(), shape))
    axes = [(a,) for a in axis_names]
    if "pod" in axis_names:
        axes.append(("pod", "data"))
    groups = {}
    for names in axes:
        dims = tuple(axis_names.index(a) for a in names)
        if all(shape[d] == 1 for d in dims):
            continue
        g = dist.new_group(_axis_ranks(shape, coords, dims))
        groups[names[0] if len(names) == 1 else names] = g
    return Mesh(devices=grid, coords=coords, groups=groups, backend="fake",
                axis_names=tuple(axis_names))


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The JAX package's production mesh — one pod, ``(data 16, model
    16)``, or two, ``(pod 2, data 16, model 16)`` — seen from this
    process's rank of a :func:`virtual_world` of its 256 or 512 cells."""
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    return virtual_mesh(shape, axes)


@contextlib.contextmanager
def virtual_world(rank: int, world: int):
    """``torch.distributed`` on the fake backend over ``world`` ranks, as
    rank ``rank``: every collective returns at once and touches no data,
    so one process runs one rank's program (on ``meta`` tensors) as if
    the other ranks were there.  The dry run's stand-in for JAX's
    placeholder devices.  The process group is destroyed on exit, also
    when the block raises; a world already initialised is refused."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("virtual_world: torch.distributed is already "
                           "initialised in this process")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def single_device_mesh(device=None) -> Mesh:
    return make_mesh(1, 1, devices=None if device is None else [device])


def default_backend(devices) -> str:
    """``nccl`` when every cell has a card of its own, ``gloo`` when cells
    share a device (NCCL refuses two ranks on one card) or run on the
    CPU."""
    devices = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devices) and \
            len(set(map(str, devices))) == len(devices):
        return "nccl"
    return "gloo"


def _rank_main(fn, rank, data, model, devices, backend, init, args,
               threads, out):
    """One rank: join the group, build the mesh, run ``fn(mesh, *args)``
    and send back ``(rank, ok, result or traceback)``."""
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = torch.device(devices[rank])
        if dev.type == "cuda" and dev.index is not None:
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init,
                                world_size=data * model, rank=rank)
        mesh = make_mesh(data, model, devices=devices, backend=backend)
        result = fn(mesh, *args)
        # the model row's gloo group where there is one (serving TP)
        dist.barrier(group=mesh.cpu_group if data == 1 else None)
        out.put((rank, True, result))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_ranks(fn, data: int, model: int, *, devices, backend: str,
                 args=(), threads: Optional[int] = None,
                 timeout: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` on the ``data * model`` cells of a mesh,
    one process each, and return every rank's result, rank 0's first.

    Each rank is a process of its own (``multiprocessing``, ``spawn``)
    joined to a ``backend`` group through a rendezvous file in a fresh
    temporary directory (no port to collide on); rank r is cell
    ``divmod(r, model)`` and runs on ``devices[r]``, with
    ``torch.set_num_threads(threads)`` when given.  ``fn`` must be
    importable by name (a module-level function) and return host objects.
    A rank that raises or dies fails the launch, and the other ranks are
    stopped: nothing falls back to fewer ranks."""
    n = data * model
    devices = [str(torch.device(d)) for d in devices]
    if len(devices) != n:
        raise ValueError(f"launch_ranks: {len(devices)} devices for {n} "
                         "ranks")
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro-ranks-")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(fn, r, data, model, devices, backend, init,
                               args, threads, out))
             for r in range(n)]
    results: dict = {}
    deadline = None if timeout is None else time.monotonic() + timeout
    try:
        for p in procs:
            p.start()
        while len(results) < n:
            try:
                rank, ok, payload = out.get(timeout=0.5)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if p.exitcode not in (None, 0)]
                if dead or all(p.exitcode == 0 for p in procs) \
                        and out.empty():
                    raise RuntimeError(f"rank(s) exited without a result: "
                                       f"{dead}")
                if deadline is not None and time.monotonic() > deadline:
                    raise TimeoutError(f"launch_ranks: no result within "
                                       f"{timeout} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{payload}")
            results[rank] = payload
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(n)]
