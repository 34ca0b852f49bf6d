"""Allocation -> device grid bridge: the point where the SLURM layer hands
a job's cards to the PyTorch layer.

The port of the JAX package's ``cluster/meshbridge.py``.  Where that module
builds a ``jax.sharding.Mesh``, this one returns the job's devices as a
``(data, model)`` grid of ``torch.device``: a job allocated N hosts x G
cards gets ``N * G`` devices, folded onto however many exist in the
process the same way the reference folds its mesh.  The grid feeds
``launch.mesh.launch_ranks`` (:func:`launch_on_mesh`): a job allocated N
cards starts one rank a card, each the ``Trainer`` of its mesh cell; a
one-card job script runs its ``Trainer`` in process on
``mesh.devices.flat[0]``.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.cluster.cluster import Cluster
from repro_torch.cluster.job import Job


@dataclass(frozen=True)
class DeviceMesh:
    """A ``(data, model)`` grid of ``torch.device`` (object array)."""
    devices: np.ndarray
    axis_names: tuple[str, ...] = ("data", "model")


def allocation_chip_count(cluster: Cluster, job: Job,
                          gres_name: str = "tpu") -> int:
    return sum(cluster.nodes[nm].gres.get(gres_name, 0)
               for nm in job.nodes_alloc)


def factor_mesh(n_chips: int, model_parallel: int) -> tuple[int, int]:
    """(data, model) shape for n_chips total."""
    model = math.gcd(model_parallel, n_chips)
    return n_chips // model, model


def mesh_for_job(cluster: Cluster, job: Job, model_parallel: int = 1,
                 devices=None) -> DeviceMesh:
    """Build the (data, model) device grid for a running job's allocation.

    ``devices=None`` means ``cuda:0 .. cuda:count-1``; without CUDA the
    caller must name the devices (there is no CPU fallback)."""
    if not job.nodes_alloc:
        raise ValueError(f"job {job.job_id} has no allocation")
    # gres/gpu on GPU hosts, gres/tpu on the JAX package's TPU inventory
    n_chips = (allocation_chip_count(cluster, job, "gpu")
               or allocation_chip_count(cluster, job))
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "mesh_for_job: no CUDA device; pass devices= explicitly")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n_chips:
        # fold the logical mesh onto the available devices, as the JAX
        # package's mesh_for_job does
        n_chips = 2 ** int(math.log2(max(1, len(devices))))
    data, model = factor_mesh(n_chips, model_parallel)
    dev = np.empty(data * model, dtype=object)
    dev[:] = devices[:data * model]
    return DeviceMesh(dev.reshape(data, model))


def launch_on_mesh(dmesh: DeviceMesh, fn, *, backend=None, args=(),
                   threads=None, timeout=None) -> list:
    """Run ``fn(mesh, *args)`` on one rank per cell of a job's device grid
    (``launch.mesh.launch_ranks``; ``backend`` default: NCCL when every
    cell has a card of its own, gloo when cells share one) and return the
    ranks' results, rank 0's first."""
    from repro_torch.launch.mesh import default_backend, launch_ranks

    devices = list(dmesh.devices.flat)
    data, model = dmesh.devices.shape
    return launch_ranks(fn, data, model, devices=devices,
                        backend=backend or default_backend(devices),
                        args=args, threads=threads, timeout=timeout)
