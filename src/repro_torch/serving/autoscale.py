"""Elastic replica autoscaling: serving scavenges the cluster's idle nodes.

The burst-parallel idea (PAPERS.md) applied to serving: decode-engine
replicas run as *scavenger-QOS placeholder jobs* inside the SLURM
simulation, so the cluster's own policy machinery — fair-share billing,
GrpTRES caps, QOS preemption — governs how much of the cluster serving
may hold at any moment.

* **Growth** — each :meth:`Autoscaler.tick` asks the scheduler's
  ``slurm_now``-style probe (:meth:`Cluster.capacity_now`, "largest
  scavenger job that starts immediately") whether one more
  replica-shaped job would start *right now*.  While it would and the
  fleet is under ``max_replicas``, the autoscaler submits the placeholder
  job, verifies it started, and brings up a router replica against the
  shared ledger.  No capacity, no growth — serving never queues batch
  work out.
* **Drain** — batch pressure takes nodes back through the path that
  already exists: a normal/high-QOS job preempts the scavenger
  placeholder (requeue mode), the tick notices the job lost RUNNING, and
  the router drains that replica — in-flight requests are evicted with
  partial output retained and resume on a surviving replica,
  bit-identical (greedy decode is batch-independent).  When pending
  batch work *cannot* preempt (scavenger-vs-scavenger), the tick drains
  the emptiest replica proactively and cancels its job so the batch work
  starts on the freed nodes.
* **Floor** — ``min_replicas`` replicas keep serving even when their
  placeholder job is knocked out (the job waits requeued; interactive
  traffic must not go to zero because the cluster is busy).

The placeholder job's ``script`` is None: the decode engine lives in the
serving process, the job just owns the nodes.  ``Job.kind`` marks it so
squeue/sdiag and the pressure check can tell replicas from real batch
work.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.cluster.job import JOB_KIND_SERVE_REPLICA, JobState, \
    ResourceRequest


class Autoscaler:
    """Grows the router's replica fleet into idle nodes; shrinks it when
    the cluster takes them back.

    ``req`` is the per-replica node shape (default: one whole node's
    gres, the JAX package's ``tpu: 4``, so that one scenario runs on
    both packages; the serve CLI passes ``gpu: 4``); each replica is one
    ``kind="serve_replica"`` scavenger job.
    Call :meth:`tick` from the serving loop — it is cheap (one capacity
    probe plus dict scans) and idempotent when nothing changed.
    """

    def __init__(self, router, cluster, req: Optional[ResourceRequest] = None,
                 min_replicas: int = 1, max_replicas: int = 4,
                 partition: Optional[str] = None, user: str = "serving",
                 account: Optional[str] = None, qos: str = "scavenger",
                 time_limit_s: int = 3600):
        assert 1 <= min_replicas <= max_replicas
        self.router = router
        self.cluster = cluster
        self.req = req if req is not None else ResourceRequest(
            nodes=1, gres_per_node={"tpu": 4}, time_limit_s=time_limit_s)
        self.min_replicas = min_replicas
        self.max_replicas = max_replicas
        self.partition = partition
        self.user = user
        self.account = account
        self.qos = qos
        #: replica id -> its placeholder job id
        self.jobs: dict[int, int] = {}
        self.stats = {"ticks": 0, "scale_ups": 0, "drains": 0,
                      "requeued_requests": 0, "last_probe": 0}

    # ------------------------------------------------------------- ticks ----
    def tick(self):
        """One control-loop pass: reap lost jobs, yield to batch
        pressure, then grow into whatever is idle."""
        self.stats["ticks"] += 1
        self._reap_lost_jobs()
        self._yield_to_batch()
        self._scale_up()

    def _batch_pressure(self) -> bool:
        return any(j.kind != JOB_KIND_SERVE_REPLICA
                   for j in self.cluster._pending())

    def _reap_lost_jobs(self):
        """Replicas whose placeholder job is no longer RUNNING (QOS
        preemption requeued it, wall limit ended it, someone cancelled
        it) lose their nodes: drain them through the router — except the
        ``min_replicas`` floor, which keeps serving on a waiting job."""
        for rid, jid in sorted(self.jobs.items()):
            job = self.cluster.jobs[jid]
            if job.state == JobState.RUNNING:
                continue
            if len(self.router.replicas) <= self.min_replicas:
                continue
            if not job.state.finished:
                self.cluster.cancel(jid)
            del self.jobs[rid]
            self._drain(rid)

    def _yield_to_batch(self):
        """Pending non-replica work with no idle capacity to start on:
        give back the emptiest replica's nodes (the cluster's own QOS
        preemption handles preempting-QOS batch work before this runs —
        this path is for peers that cannot evict us)."""
        while (len(self.router.replicas) > self.min_replicas
               and self._batch_pressure()
               and self._probe() < self.req.nodes):
            managed = [r for r in self.jobs if r in self.router.replicas]
            if not managed:
                break
            rid = min(managed, key=lambda r: (self.router.load(r), r))
            jid = self.jobs.pop(rid)
            self.cluster.cancel(jid)
            self._drain(rid)

    def _scale_up(self):
        while (len(self.router.replicas) < self.max_replicas
               and self._probe() >= self.req.nodes):
            jid = self.cluster.submit(
                f"serve-replica-{len(self.jobs)}", self.req, user=self.user,
                partition=self.partition, account=self.account, qos=self.qos,
                run_time_s=float(self.req.time_limit_s),
                kind=JOB_KIND_SERVE_REPLICA)[0]
            if self.cluster.jobs[jid].state != JobState.RUNNING:
                # the probe said yes but scheduling said no (e.g. a
                # GrpTRES hold on the scavenger account) — back out
                self.cluster.cancel(jid)
                break
            rid = self.router.add_replica()
            self.jobs[rid] = jid
            self.stats["scale_ups"] += 1

    # ----------------------------------------------------------- helpers ----
    def _probe(self) -> int:
        n = self.cluster.capacity_now(self.req, self.partition)
        self.stats["last_probe"] = n
        return n

    def _drain(self, rid: int):
        moved = self.router.remove_replica(rid)
        self.stats["drains"] += 1
        self.stats["requeued_requests"] += moved
