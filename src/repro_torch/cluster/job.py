"""Jobs: resource requests, lifecycle state machine, dependencies, arrays.

Mirrors the paper's §5.2 submission model: every ``#SBATCH`` option in the
guide's example script has a field here (job-name, partition, nodes, gres,
cpus-per-task, mem, time), plus dependencies (``-d afterok:<id>``) and job
arrays (``-a``).
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field
from typing import Callable, Optional


class JobState(enum.Enum):
    PENDING = "PD"
    RUNNING = "R"
    COMPLETED = "CD"
    FAILED = "F"
    CANCELLED = "CA"
    TIMEOUT = "TO"
    PREEMPTED = "PR"         # transient: evicted, about to requeue

    @property
    def finished(self) -> bool:
        return self in (JobState.COMPLETED, JobState.FAILED,
                        JobState.CANCELLED, JobState.TIMEOUT)

    @property
    def ok(self) -> bool:
        return self == JobState.COMPLETED


#: Job.kind for serving-replica placeholder jobs: the autoscaler submits
#: one per decode-engine replica (scavenger QOS) so the replica's nodes
#: are owned, billed, and preemptable like any other job.
JOB_KIND_SERVE_REPLICA = "serve_replica"


class DependencyKind(enum.Enum):
    AFTER = "after"          # dep started (or finished)
    AFTEROK = "afterok"      # dep completed successfully
    AFTERNOTOK = "afternotok"
    AFTERANY = "afterany"    # dep finished in any state


@dataclass(frozen=True)
class Dependency:
    kind: DependencyKind
    job_id: int

    @classmethod
    def parse(cls, text: str) -> list["Dependency"]:
        """Parse SLURM syntax ``afterok:12:13,afterany:14``."""
        deps = []
        for clause in text.split(","):
            kind, *ids = clause.split(":")
            for jid in ids:
                deps.append(cls(DependencyKind(kind), int(jid)))
        return deps


@dataclass(frozen=True)
class ResourceRequest:
    """What one job asks for (per the guide's sbatch options)."""
    nodes: int = 1
    gres_per_node: dict = field(default_factory=dict)   # {"tpu": 4}
    cpus_per_node: int = 1
    mem_mb_per_node: int = 1024
    time_limit_s: int = 3600
    contiguous: bool = True     # TPU: allocation must tile a mesh rectangle

    def __post_init__(self):
        assert self.nodes >= 1 and self.cpus_per_node >= 1
        assert self.time_limit_s > 0


@dataclass
class Job:
    job_id: int
    name: str
    user: str
    partition: str
    req: ResourceRequest
    priority: int = 0
    submit_time: float = 0.0
    # what the job "runs": either a simulated duration, or a real callable
    # (the Mesh bridge launches JAX work through this).
    run_time_s: float = 60.0
    script: Optional[Callable] = None     # called at start in real mode
    dependencies: tuple[Dependency, ...] = ()
    array_index: Optional[int] = None     # set for array members
    comment: str = ""

    # multi-tenancy (sacctmgr association + QOS)
    account: str = "root"
    qos: str = "normal"

    # workload class: plain batch work, or a serving-replica placeholder
    # the autoscaler manages (its "script" is a decode engine outside the
    # simulation; the job holds the nodes and rides QOS preemption)
    kind: str = "batch"

    # preemption / requeue
    requeue_count: int = 0                # times evicted back to PENDING
    progress_s: float = 0.0               # checkpointed work retained
    ckpt_interval_s: Optional[float] = None   # sim: progress granularity
    checkpoint_dir: Optional[str] = None  # real mode: checkpoint.store

    # lifecycle
    state: JobState = JobState.PENDING
    reason: str = "Priority"
    start_time: Optional[float] = None
    end_time: Optional[float] = None
    nodes_alloc: tuple[str, ...] = ()
    exit_code: Optional[int] = None
    result: object = None                 # script return value (real mode)

    @property
    def time_limit_s(self) -> int:
        return self.req.time_limit_s

    def remaining_s(self) -> float:
        """Work left after checkpointed progress (full run if never saved)."""
        return max(self.run_time_s - self.progress_s, 0.0)

    def runtime(self) -> float:
        """Actual runtime of the *current segment* (capped by the limit —
        TIMEOUT if it would exceed; the limit resets per requeue segment,
        matching SLURM's requeue semantics)."""
        return min(self.remaining_s(), self.req.time_limit_s)

    def will_timeout(self) -> bool:
        return self.remaining_s() > self.req.time_limit_s

    def record_preemption(self, elapsed_s: float):
        """Evicted after ``elapsed_s`` of this segment: keep checkpointed
        progress (last full ``ckpt_interval_s`` multiple; none → restart)."""
        if self.ckpt_interval_s:
            kept = (elapsed_s // self.ckpt_interval_s) * self.ckpt_interval_s
            self.progress_s += kept
        self.requeue_count += 1

    def sort_key(self) -> tuple:
        """Queue order: higher priority first, then FIFO by submit time."""
        return (-self.priority, self.submit_time, self.job_id)

    def real_failed(self) -> bool:
        """Real-mode script raised at start (exit code already recorded)."""
        return self.exit_code == 1 and self.script is not None
