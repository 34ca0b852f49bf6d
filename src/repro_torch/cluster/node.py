"""Software-defined cluster inventory: nodes, GRES, partitions.

Adaptation note (DESIGN.md): the paper's node is a Linux host with 1–8
GPUs (``gres/gpu:N``); ours is a TPU host with 4 chips (``gres/tpu:4``).
Everything else — state machine, CPU/memory accounting, partitions with
priority tiers and time limits — is SLURM semantics kept intact.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field, replace
from typing import Optional


class NodeState(enum.Enum):
    IDLE = "idle"
    MIXED = "mixed"          # partially allocated
    ALLOCATED = "alloc"
    DOWN = "down"
    DRAIN = "drain"          # no new jobs; running jobs finish

    @property
    def schedulable(self) -> bool:
        return self in (NodeState.IDLE, NodeState.MIXED)


@dataclass
class Node:
    """One compute host.  GRES follows SLURM's ``name:count`` model."""
    name: str
    cpus: int = 16
    mem_mb: int = 131_072
    gres: dict = field(default_factory=lambda: {"tpu": 4})
    features: tuple[str, ...] = ()          # e.g. ("v5e", "ici")
    # TPU topology coordinates within the pod mesh (row, col of the 4-chip
    # host in the 16x16 chip grid).  GPUs don't have this constraint; TPUs do
    # — allocations must form contiguous sub-rectangles.
    coord: Optional[tuple[int, int]] = None
    state: NodeState = NodeState.IDLE
    reason: str = ""

    # live accounting
    alloc_cpus: int = 0
    alloc_mem_mb: int = 0
    alloc_gres: dict = field(default_factory=dict)
    running_jobs: set = field(default_factory=set)

    def clone(self) -> "Node":
        """Cheap scheduling-shadow copy: shares the immutable inventory
        (name/cpus/mem/gres/coord/features) and copies only the mutable
        allocation state.  ~10x faster than ``copy.deepcopy`` for the
        per-pass working sets the scheduler builds."""
        c = Node.__new__(Node)
        c.name = self.name
        c.cpus = self.cpus
        c.mem_mb = self.mem_mb
        c.gres = self.gres                  # never mutated after provisioning
        c.features = self.features
        c.coord = self.coord
        c.state = self.state
        c.reason = self.reason
        c.alloc_cpus = self.alloc_cpus
        c.alloc_mem_mb = self.alloc_mem_mb
        c.alloc_gres = dict(self.alloc_gres)
        c.running_jobs = set(self.running_jobs)
        return c

    # ---- capacity queries ----
    def free_cpus(self) -> int:
        return self.cpus - self.alloc_cpus

    def free_mem_mb(self) -> int:
        return self.mem_mb - self.alloc_mem_mb

    def free_gres(self, name: str) -> int:
        return self.gres.get(name, 0) - self.alloc_gres.get(name, 0)

    def fits(self, cpus: int, mem_mb: int, gres: dict) -> bool:
        if not self.state.schedulable:
            return False
        if cpus > self.free_cpus() or mem_mb > self.free_mem_mb():
            return False
        return all(self.free_gres(g) >= n for g, n in gres.items())

    # ---- allocation bookkeeping ----
    def allocate(self, job_id: int, cpus: int, mem_mb: int, gres: dict):
        assert self.fits(cpus, mem_mb, gres), (self.name, job_id)
        self.alloc_cpus += cpus
        self.alloc_mem_mb += mem_mb
        for g, n in gres.items():
            self.alloc_gres[g] = self.alloc_gres.get(g, 0) + n
        self.running_jobs.add(job_id)
        self._refresh_state()

    def release(self, job_id: int, cpus: int, mem_mb: int, gres: dict):
        self.alloc_cpus -= cpus
        self.alloc_mem_mb -= mem_mb
        for g, n in gres.items():
            self.alloc_gres[g] = self.alloc_gres.get(g, 0) - n
        self.running_jobs.discard(job_id)
        self._refresh_state()

    def _refresh_state(self):
        if self.state in (NodeState.DOWN, NodeState.DRAIN):
            return
        if self.alloc_cpus == 0 and not any(self.alloc_gres.values()):
            self.state = NodeState.IDLE
        elif self.free_cpus() == 0 or all(
                self.free_gres(g) == 0 for g in self.gres):
            self.state = NodeState.ALLOCATED
        else:
            self.state = NodeState.MIXED

    def set_state(self, state: NodeState, reason: str = ""):
        self.state = state
        self.reason = reason
        if state not in (NodeState.DOWN, NodeState.DRAIN):
            self._refresh_state()


@dataclass(frozen=True)
class Partition:
    """SLURM partition: a named group of nodes with policy attached."""
    name: str
    nodes: tuple[str, ...]
    max_time_s: int = 24 * 3600
    priority_tier: int = 1          # higher tier preempts queue order
    default: bool = False
