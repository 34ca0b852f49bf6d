"""Multifactor priority — the classic SLURM composition::

    prio = W_age  * age_factor
         + W_fs   * 2^(-usage/shares)        (the fair-share factor)
         + W_size * job_size_factor
         + W_part * partition_factor
         + W_qos  * qos_factor
         + nice   (the job's static priority)

Starved accounts rise (usage decays toward 0 → factor → 1); dominant
accounts sink (usage ≫ shares → factor → 0).  The convergence property
is proven in ``tests/test_multitenant.py``.

Duck-typed over any workload carrying ``job_id`` / ``account`` / ``qos`` /
``submit_time`` / ``priority`` / ``partition`` / ``req.nodes`` — the batch
scheduler feeds it Jobs; serving admission composes the same fair-share
and QOS terms for requests (see ``repro_torch.serving.admission``).
"""
from __future__ import annotations

from dataclasses import dataclass

from repro_torch.policy.qos import QOS
from repro_torch.policy.usage import FairShareTree


@dataclass(frozen=True)
class PriorityWeights:
    """slurm.conf ``PriorityWeight*`` knobs."""
    age: float = 1_000.0
    fairshare: float = 10_000.0
    job_size: float = 500.0
    partition: float = 1_000.0
    qos: float = 2_000.0
    max_age_s: float = 7 * 86_400.0     # PriorityMaxAge


@dataclass(frozen=True)
class PriorityBreakdown:
    """One sprio row: the weighted components and their sum."""
    job_id: int
    age: float
    fairshare: float
    job_size: float
    partition: float
    qos: float
    nice: float

    @property
    def total(self) -> float:
        return (self.age + self.fairshare + self.job_size + self.partition
                + self.qos + self.nice)


class MultifactorPriority:
    """The priority/multifactor plugin: compose factors into one number."""

    def __init__(self, tree: FairShareTree,
                 qos_table: dict[str, QOS],
                 weights: PriorityWeights = PriorityWeights()):
        self.tree = tree
        self.qos_table = qos_table
        self.weights = weights

    def breakdown(self, job, now: float, partitions: dict,
                  cluster_nodes: int) -> PriorityBreakdown:
        w = self.weights
        age = min(max(now - job.submit_time, 0.0) / w.max_age_s, 1.0)
        fs = self.tree.fair_share_factor(job.account)
        size = job.req.nodes / max(cluster_nodes, 1)
        part = partitions[job.partition].priority_tier if job.partition in \
            partitions else 1
        max_tier = max((p.priority_tier for p in partitions.values()),
                       default=1)
        qos = self.qos_table.get(job.qos)
        max_qos = max((q.priority for q in self.qos_table.values()),
                      default=1) or 1
        return PriorityBreakdown(
            job_id=job.job_id,
            age=w.age * age,
            fairshare=w.fairshare * fs,
            job_size=w.job_size * size,
            partition=w.partition * part / max(max_tier, 1),
            qos=w.qos * (qos.priority / max_qos if qos else 0.0),
            nice=float(job.priority),
        )

    def priority(self, job, now: float, partitions: dict,
                 cluster_nodes: int) -> float:
        return self.breakdown(job, now, partitions, cluster_nodes).total

    def priority_fn(self, now: float, partitions: dict, cluster_nodes: int):
        """A ``job -> priority`` callable for one scheduling pass (the
        fair-share factor is frozen at pass start, like SLURM's decay tick).
        """
        cache: dict[int, float] = {}

        def fn(job) -> float:
            p = cache.get(job.job_id)
            if p is None:
                p = self.priority(job, now, partitions, cluster_nodes)
                cache[job.job_id] = p
            return p
        return fn
