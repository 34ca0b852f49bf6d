"""The cluster engine: inventory + job table + virtual clock + event loop.

Deterministic discrete-event simulation of a SLURM-managed TPU cluster.
`sbatch`-style submission enqueues jobs; `tick()` advances the clock to the
next event (job end), releases resources, resolves dependencies, and runs a
scheduling pass.  Jobs carrying a real ``script`` callable execute it at
start time — this is how the examples launch actual JAX work through the
Mesh bridge.

HA (paper §4 step 3 note on ``slurm_enable_ha``): the full controller state
serializes to a dict (``snapshot()``) and a standby controller restores from
it (``Cluster.restore``) — the failover test proves no job state is lost.
The fair-share ledger rides along, so a failover keeps every tenant's decayed
usage (no free reset for the hog).

Multi-tenancy: every job belongs to an (account, QOS) pair.  Queue order
comes from the multifactor fair-share engine (``repro_torch.policy``); finished
and preempted segments charge TRES-seconds to the account tree; a high-QOS
job that cannot start may preempt scavenger/normal victims, which requeue
(keeping checkpointed progress via ``repro_torch.checkpoint.store``) or are
cancelled, per the victim QOS's ``preempt_mode``.
"""
from __future__ import annotations

import itertools
import time
from dataclasses import dataclass, field
from typing import Callable, Optional

from repro_torch.cluster.job import (
    Dependency, DependencyKind, Job, JobState, ResourceRequest,
)
from repro_torch.cluster.node import Node, NodeState, Partition
from repro_torch.cluster.scheduler import (
    Decision, capacity_probe, schedule_pass,
)
from repro_torch.policy import (
    PREEMPT_CANCEL, QOS, FairShareTree, MultifactorPriority,
    PriorityWeights, default_qos_table,
)

#: bound on preempt -> requeue -> rerun cycles inside one schedule() call
_MAX_PREEMPT_ROUNDS = 8


@dataclass
class AccountingRecord:
    """One sacct row (a preempted job contributes one row per segment)."""
    job_id: int
    name: str
    user: str
    partition: str
    submit: float
    start: Optional[float]
    end: Optional[float]
    state: str
    nodes: tuple[str, ...]
    elapsed: float
    exit_code: Optional[int]
    account: str = "root"
    qos: str = "normal"
    tres_charged: float = 0.0          # weighted TRES-seconds billed


class Cluster:
    """Software-defined SLURM cluster (controller + inventory)."""

    def __init__(self, nodes: list[Node], partitions: list[Partition],
                 sched_mode: str = "easy", real_mode: bool = False,
                 fairshare: Optional[FairShareTree] = None,
                 qos_table: Optional[dict[str, QOS]] = None,
                 priority_weights: Optional[PriorityWeights] = None):
        self.nodes: dict[str, Node] = {n.name: n for n in nodes}
        self.partitions: dict[str, Partition] = {p.name: p for p in partitions}
        for p in partitions:
            for nm in p.nodes:
                assert nm in self.nodes, f"partition {p.name}: unknown {nm}"
        self.sched_mode = sched_mode
        self.real_mode = real_mode
        self.clock: float = 0.0
        self.jobs: dict[int, Job] = {}
        # live view of non-terminal jobs, so scheduling passes stay O(active)
        # instead of rescanning the whole (append-only) job table — the
        # difference between O(n) and O(n^2) over a long simulation
        self._active: dict[int, Job] = {}
        self.accounting: list[AccountingRecord] = []
        self._next_id = itertools.count(1)
        self.metrics = None            # optional monitoring registry hook
        self.tracer = None             # optional lifecycle tracer hook
        # sdiag-style scheduler statistics: wall time per schedule_pass
        # (the virtual clock stamps the spans; these stats time the REAL
        # cost of a controller cycle, what SLURM's sdiag reports)
        self.sched_stats = {"passes": 0, "last_us": 0.0, "total_us": 0.0,
                            "max_us": 0.0, "starts": 0}
        # slurm_now-style capacity probes (autoscaler growth signal)
        self.probe_stats = {"probes": 0, "last_nodes": 0}
        self.fairshare = fairshare or FairShareTree()
        self.qos_table = dict(qos_table) if qos_table is not None \
            else default_qos_table()
        self.priority_engine = MultifactorPriority(
            self.fairshare, self.qos_table,
            priority_weights or PriorityWeights())
        self.preemptions_total = 0

    # ------------------------------------------------------------ submit ----
    def default_partition(self) -> str:
        for p in self.partitions.values():
            if p.default:
                return p.name
        return next(iter(self.partitions))

    def submit(self, name: str, req: ResourceRequest, user: str = "ubuntu",
               partition: Optional[str] = None, priority: int = 0,
               run_time_s: float = 60.0, script: Optional[Callable] = None,
               dependency: str = "", array: int = 0,
               comment: str = "", account: Optional[str] = None,
               qos: str = "normal", ckpt_interval_s: Optional[float] = None,
               checkpoint_dir: Optional[str] = None,
               kind: str = "batch") -> list[int]:
        """sbatch.  Returns job id(s) (``array > 0`` submits an array)."""
        partition = partition or self.default_partition()
        if partition not in self.partitions:
            raise ValueError(f"invalid partition {partition!r}")
        if qos not in self.qos_table:
            raise ValueError(f"invalid qos {qos!r} "
                             f"(have {sorted(self.qos_table)})")
        q = self.qos_table[qos]
        if q.max_wall_s is not None and req.time_limit_s > q.max_wall_s:
            raise ValueError(f"time limit {req.time_limit_s}s exceeds QOS "
                             f"{qos} MaxWall {q.max_wall_s}s")
        if req.time_limit_s > self.partitions[partition].max_time_s:
            raise ValueError(
                f"time limit {req.time_limit_s}s exceeds partition max "
                f"{self.partitions[partition].max_time_s}s")
        if account is None:
            account = self.fairshare.account_of(user)
        elif account not in self.fairshare.accounts:
            self.fairshare.add_account(account)   # lenient auto-association
        deps = tuple(Dependency.parse(dependency)) if dependency else ()
        for d in deps:
            if d.job_id not in self.jobs:
                raise ValueError(f"dependency on unknown job {d.job_id}")
        n = max(array, 1)
        ids = []
        for i in range(n):
            jid = next(self._next_id)
            job = Job(
                job_id=jid, name=name, user=user, partition=partition,
                req=req, priority=priority, submit_time=self.clock,
                run_time_s=run_time_s, script=script, dependencies=deps,
                array_index=i if array else None, comment=comment,
                account=account, qos=qos, ckpt_interval_s=ckpt_interval_s,
                checkpoint_dir=checkpoint_dir, kind=kind)
            self.jobs[jid] = job
            if not job.state.finished:
                self._active[jid] = job
            self._refresh_dependency(job)
            self._trace_job_submit(job)
            ids.append(jid)
        self.schedule()
        return ids

    def capacity_now(self, req: ResourceRequest,
                     partition: Optional[str] = None) -> int:
        """slurm_now: the largest node count a job shaped like ``req``
        could start immediately (the autoscaler's growth probe).  Pure
        read — nothing is submitted, reserved, or preempted."""
        part = self.partitions[partition or self.default_partition()]
        n = capacity_probe(self.nodes, part, req)
        self.probe_stats["probes"] += 1
        self.probe_stats["last_nodes"] = n
        return n

    def cancel(self, job_id: int):
        """scancel."""
        job = self.jobs[job_id]
        if job.state.finished:
            return
        if job.state == JobState.RUNNING:
            self._finish(job, JobState.CANCELLED)
        else:
            job.state = JobState.CANCELLED
            job.end_time = self.clock
            self._trace_job_close(job, "CANCELLED")
            self._retire(job)
            self._account(job)
        self.schedule()

    def update_job(self, job_id: int, **kwargs):
        """scontrol update job — only pending jobs may change resources."""
        job = self.jobs[job_id]
        if "priority" in kwargs:
            job.priority = int(kwargs.pop("priority"))
        if kwargs and job.state != JobState.PENDING:
            raise ValueError("cannot modify a non-pending job's resources")
        for k, v in kwargs.items():
            setattr(job, k, v)
        self.schedule()

    def set_node_state(self, name: str, state: NodeState, reason: str = ""):
        """scontrol update nodename=... state=... (drain/down/resume)."""
        node = self.nodes[name]
        node.set_state(state, reason)
        if state == NodeState.DOWN:
            # requeue jobs that lost their node (SLURM requeues on failure)
            for jid in list(node.running_jobs):
                job = self.jobs[jid]
                self._release_nodes(job)
                job.state = JobState.PENDING
                job.reason = "BeginTime"
                job.start_time = None
                job.nodes_alloc = ()
                self._trace_job_state(job, "PENDING", reason="NodeDown")
        self.schedule()

    # ----------------------------------------------------------- tracing ----
    # Job lifecycle spans share the serving tracer's timeline; the virtual
    # clock stamps them (ts=self.clock), so simulated jobs and wall-clock
    # serving requests render side by side in Perfetto.  One root span per
    # job, with back-to-back state child spans (PENDING/RUNNING/...).
    def _trace_job_submit(self, job: Job):
        tr = self.tracer
        if tr is None or job.state.finished:
            return
        root = tr.begin(f"job {job.job_id}", cat="job",
                        track=(f"cluster:{job.account}",
                               f"job {job.job_id}"),
                        ts=self.clock, job_name=job.name, user=job.user,
                        partition=job.partition, qos=job.qos,
                        account=job.account)
        tr.event("SUBMIT", root, ts=self.clock)
        state = tr.begin("PENDING", cat="state", parent=root,
                         ts=self.clock, reason=job.reason)
        job._trace = {"root": root, "state": state}

    def _trace_job_state(self, job: Job, name: str, **attrs):
        """End the current state span, open the next one."""
        tr = self.tracer
        trace = getattr(job, "_trace", None)
        if tr is None or not trace:
            return
        cur = trace.pop("state", None)
        if cur is not None:
            tr.end(cur, ts=self.clock)
        trace["state"] = tr.begin(name, cat="state", parent=trace["root"],
                                  ts=self.clock, **attrs)

    def _trace_job_close(self, job: Job, state: str):
        """Terminal transition: close the state span and the root."""
        tr = self.tracer
        trace = getattr(job, "_trace", None)
        if tr is None or not trace:
            return
        cur = trace.pop("state", None)
        if cur is not None:
            tr.end(cur, ts=self.clock)
        root = trace.pop("root", None)
        if root is not None:
            tr.event(state, root, ts=self.clock)
            tr.end(root, ts=self.clock, state=state)

    # --------------------------------------------------------- scheduling ----
    def _retire(self, job: Job):
        """Drop a job that reached a terminal state from the active view."""
        self._active.pop(job.job_id, None)

    def _pending(self) -> list[Job]:
        return [j for j in self._active.values()
                if j.state == JobState.PENDING]

    def _running(self) -> list[Job]:
        return [j for j in self._active.values()
                if j.state == JobState.RUNNING]

    def _refresh_dependency(self, job: Job):
        """Update the Dependency gate / fail jobs with impossible deps."""
        blocked = False
        for d in job.dependencies:
            dep = self.jobs.get(d.job_id)
            if dep is None:
                continue
            if d.kind == DependencyKind.AFTEROK:
                if dep.state.finished and not dep.state.ok:
                    job.state = JobState.CANCELLED   # DependencyNeverSatisfied
                    job.end_time = self.clock
                    job.reason = "DependencyNeverSatisfied"
                    self._trace_job_close(job, "CANCELLED")
                    self._retire(job)
                    self._account(job)
                    return
                blocked |= not dep.state.ok
            elif d.kind == DependencyKind.AFTERNOTOK:
                if dep.state.ok:
                    job.state = JobState.CANCELLED
                    job.end_time = self.clock
                    job.reason = "DependencyNeverSatisfied"
                    self._trace_job_close(job, "CANCELLED")
                    self._retire(job)
                    self._account(job)
                    return
                blocked |= not dep.state.finished
            elif d.kind == DependencyKind.AFTERANY:
                blocked |= not dep.state.finished
            elif d.kind == DependencyKind.AFTER:
                blocked |= dep.start_time is None
        job.reason = "Dependency" if blocked else "Priority"

    def schedule(self) -> Decision:
        for job in self._pending():
            self._refresh_dependency(job)
        self.fairshare.decay_to(self.clock)
        decision = None
        for _ in range(_MAX_PREEMPT_ROUNDS):
            priority_fn = self.priority_engine.priority_fn(
                self.clock, self.partitions, len(self.nodes))
            t0 = time.perf_counter()
            decision = schedule_pass(
                self.clock, self._pending(), self._running(), self.nodes,
                self.partitions, self.sched_mode, priority_fn=priority_fn,
                qos_table=self.qos_table, tracer=self.tracer)
            dt_us = (time.perf_counter() - t0) * 1e6
            st = self.sched_stats
            st["passes"] += 1
            st["last_us"] = dt_us
            st["total_us"] += dt_us
            st["max_us"] = max(st["max_us"], dt_us)
            st["starts"] += len(decision.starts)
            for job_id, alloc in decision.starts:
                self._start(self.jobs[job_id], alloc)
            for job_id, reason in decision.holds:
                job = self.jobs.get(job_id)
                if job and job.state == JobState.PENDING:
                    job.reason = reason
            for res in decision.reservations:
                job = self.jobs.get(res.job_id)
                if job and job.state == JobState.PENDING:
                    job.reason = "Resources"
            if not decision.preemptions:
                break
            for pre in decision.preemptions:
                for vid in pre.victims:
                    victim = self.jobs[vid]
                    if victim.state == JobState.RUNNING:
                        self._preempt(victim, by_job_id=pre.job_id)
        self._export_metrics()
        return decision

    def _export_metrics(self):
        if self.metrics is None:
            return
        from repro_torch.monitoring.metrics import (
            METRIC_ACCOUNT_FAIRSHARE, METRIC_ACCOUNT_USAGE,
            METRIC_JOBS_PENDING, METRIC_JOBS_RUNNING, METRIC_PREEMPTIONS,
        )
        self.metrics.gauge(METRIC_JOBS_PENDING).set(len(self._pending()))
        self.metrics.gauge(METRIC_JOBS_RUNNING).set(len(self._running()))
        self.metrics.gauge(METRIC_PREEMPTIONS).set(self.preemptions_total)
        usage = self.metrics.gauge(
            METRIC_ACCOUNT_USAGE, "decayed weighted TRES-seconds per account")
        factor = self.metrics.gauge(
            METRIC_ACCOUNT_FAIRSHARE, "fair-share factor 2^(-usage/shares)")
        for name in self.fairshare.accounts:
            usage.set(self.fairshare.usage.get(name, 0.0), account=name)
            factor.set(self.fairshare.fair_share_factor(name), account=name)

    def _start(self, job: Job, alloc: tuple[str, ...]):
        for nm in alloc:
            self.nodes[nm].allocate(job.job_id, job.req.cpus_per_node,
                                    job.req.mem_mb_per_node,
                                    job.req.gres_per_node)
        job.state = JobState.RUNNING
        job.start_time = self.clock
        job.nodes_alloc = alloc
        job.reason = ""
        self._trace_job_state(job, "RUNNING", nodes=len(alloc))
        if self.real_mode and job.script is not None:
            try:
                job.result = job.script(job, alloc)
                job.exit_code = 0
            except Exception as e:              # noqa: BLE001 — job failure
                job.exit_code = 1
                job.comment = f"{type(e).__name__}: {e}"

    def _release_nodes(self, job: Job):
        for nm in job.nodes_alloc:
            self.nodes[nm].release(job.job_id, job.req.cpus_per_node,
                                   job.req.mem_mb_per_node,
                                   job.req.gres_per_node)

    def _finish(self, job: Job, state: JobState):
        self._release_nodes(job)
        job.state = state
        job.end_time = self.clock
        if job.exit_code is None:
            job.exit_code = 0 if state == JobState.COMPLETED else 1
        self._trace_job_close(job, state.name)
        self._retire(job)
        self._account(job)

    def _preempt(self, job: Job, by_job_id: int):
        """Evict a running job for a higher-QOS one: account the finished
        segment, charge its usage, then requeue (or cancel, per the victim
        QOS's preempt_mode)."""
        assert job.state == JobState.RUNNING
        elapsed = self.clock - job.start_time
        mode = self.qos_table[job.qos].preempt_mode if job.qos in \
            self.qos_table else "requeue"
        self._release_nodes(job)
        job.end_time = self.clock
        self.preemptions_total += 1
        if self.metrics is not None:
            from repro_torch.monitoring.metrics import METRIC_PREEMPTIONS_BY
            self.metrics.counter(
                METRIC_PREEMPTIONS_BY, "preempted segments").inc(
                qos=job.qos, account=job.account)
        if mode == PREEMPT_CANCEL:
            job.state = JobState.CANCELLED
            job.reason = f"PreemptedBy={by_job_id}"
            if job.exit_code is None:
                job.exit_code = 1
            self._trace_job_close(job, "CANCELLED")
            self._retire(job)
            self._account(job)
            return
        # requeue path: one accounting row for the evicted segment
        job.state = JobState.PREEMPTED
        job.reason = f"PreemptedBy={by_job_id}"
        # zero-length PREEMPTED state between RUNNING and the requeued
        # PENDING: both transitions happen at the same virtual instant
        self._trace_job_state(job, "PREEMPTED", by=by_job_id)
        self._account(job)
        job.record_preemption(elapsed)
        self._restore_progress(job)
        job.state = JobState.PENDING
        job.reason = "Requeued"
        job.start_time = None
        job.end_time = None
        job.nodes_alloc = ()
        self._trace_job_state(job, "PENDING", reason="Requeued")

    def _restore_progress(self, job: Job):
        """Checkpoint-restore hook: a preempted job with a checkpoint dir
        resumes from its last saved step (convention: the trainer saves
        ``step = seconds of completed work``) instead of restarting."""
        if job.checkpoint_dir is None:
            return
        from repro_torch.checkpoint import store
        step = store.latest_step(job.checkpoint_dir)
        if step is not None:
            job.progress_s = max(job.progress_s, float(step))

    def _account(self, job: Job):
        elapsed = ((job.end_time - job.start_time)
                   if job.start_time is not None and job.end_time is not None
                   else 0.0)
        charged = 0.0
        if elapsed > 0:
            usage_factor = (self.qos_table[job.qos].usage_factor
                            if job.qos in self.qos_table else 1.0)
            charged = self.fairshare.charge(
                job.account, job.req, elapsed, self.clock,
                usage_factor=usage_factor)
        self.accounting.append(AccountingRecord(
            job.job_id, job.name, job.user, job.partition, job.submit_time,
            job.start_time, job.end_time, job.state.name,
            job.nodes_alloc, elapsed, job.exit_code,
            account=job.account, qos=job.qos, tres_charged=charged))

    # -------------------------------------------------------- event loop ----
    def next_event_time(self) -> Optional[float]:
        ends = [j.start_time + j.runtime() for j in self._running()]
        return min(ends) if ends else None

    def tick(self) -> bool:
        """Advance to the next job-end event.  False if nothing to do."""
        t = self.next_event_time()
        if t is None:
            return False
        self.clock = t
        for job in self._running():
            if job.start_time + job.runtime() <= self.clock + 1e-9:
                if job.real_failed():
                    self._finish(job, JobState.FAILED)
                elif job.will_timeout():
                    self._finish(job, JobState.TIMEOUT)
                else:
                    self._finish(job, JobState.COMPLETED)
        self.schedule()
        return True

    def run(self, max_events: int = 100_000):
        """Run until the queue drains (or the event budget is spent)."""
        for _ in range(max_events):
            if not self.tick():
                break
        stuck = [j.job_id for j in self._pending()]
        return stuck

    # ------------------------------------------------------------- HA -------
    def snapshot(self) -> dict:
        """Serializable controller state (for HA failover)."""
        import copy
        return {
            "clock": self.clock,
            "jobs": copy.deepcopy(self.jobs),
            "nodes": copy.deepcopy(self.nodes),
            "accounting": copy.deepcopy(self.accounting),
            "next_id": next(self._next_id),
            "sched_mode": self.sched_mode,
            "partitions": list(self.partitions.values()),
            "fairshare": self.fairshare.snapshot(),
            "qos_table": dict(self.qos_table),     # QOS objects are frozen
            "priority_weights": self.priority_engine.weights,
            "preemptions_total": self.preemptions_total,
        }

    @classmethod
    def restore(cls, snap: dict) -> "Cluster":
        c = cls.__new__(cls)
        c.nodes = snap["nodes"]
        c.partitions = {p.name: p for p in snap["partitions"]}
        c.sched_mode = snap["sched_mode"]
        c.real_mode = False
        c.clock = snap["clock"]
        c.jobs = snap["jobs"]
        c._active = {jid: j for jid, j in c.jobs.items()
                     if not j.state.finished}
        c.accounting = snap["accounting"]
        c._next_id = itertools.count(snap["next_id"])
        c.metrics = None
        c.tracer = None
        c.sched_stats = {"passes": 0, "last_us": 0.0, "total_us": 0.0,
                         "max_us": 0.0, "starts": 0}
        c.probe_stats = {"probes": 0, "last_nodes": 0}
        c.fairshare = FairShareTree.restore(
            snap.get("fairshare", FairShareTree().snapshot()))
        c.qos_table = dict(snap.get("qos_table") or default_qos_table())
        c.priority_engine = MultifactorPriority(
            c.fairshare, c.qos_table,
            snap.get("priority_weights") or PriorityWeights())
        c.preemptions_total = snap.get("preemptions_total", 0)
        return c
