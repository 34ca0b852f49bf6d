"""The SLURM scheduling policy: priority queue + EASY/conservative backfill
+ QOS preemption.

This is the paper's §3.2.3 artifact ("Slurm: scalability, fairness policies")
implemented as a deterministic, property-testable engine:

* **Priority order** — pending jobs sorted by a pluggable ``priority_fn``
  (the multifactor fair-share engine in ``fairshare.py``) falling back to
  the static (priority desc, submit FIFO) order.
* **Backfill** — when the head job can't start, it gets a *reservation* at
  the earliest projected time it fits (from running jobs' expected ends).
  Lower-priority jobs may start out of order only if they cannot delay a
  reservation (finish before it starts, or touch disjoint nodes).
  ``mode="easy"`` reserves for the first blocked job only (SLURM's default
  sched/backfill behaviour); ``mode="conservative"`` reserves for every
  blocked job.
* **QOS limits** — a job whose account already holds its QOS's ``GrpTRES``
  cap is held with reason ``QOSGrpResourceLimit``.
* **Preemption** — when a blocked job's QOS lists preemptable tiers, the
  pass selects the cheapest set of lowest-priority running victims whose
  eviction makes room, and emits them in ``Decision.preemptions``.  The
  engine in ``cluster.py`` requeues (or cancels) the victims and re-runs
  the pass so the preemptor starts on the freed nodes.
* **TPU contiguity** — allocations must tile a rectangle of hosts in the
  pod's host grid (GPUs don't have this constraint; TPU ICI does).

Pure policy: given cluster state, produce decisions.  The event engine in
``cluster.py`` applies them.
"""
from __future__ import annotations

import copy
import itertools
from dataclasses import dataclass, replace
from typing import Callable, Optional

from repro_torch.cluster.job import Job, JobState
from repro_torch.cluster.node import Node, NodeState, Partition
from repro_torch.policy import QOS, add_tres, job_tres, tres_within


class ShadowNodes:
    """Copy-on-write working view of the node inventory for one pass.

    Reads pass through to the base mapping; a node is cloned only when a
    tentative placement actually touches it (``mutate``).  A pass that
    starts k small jobs on a 256-node cluster clones k·nodes-per-job
    nodes instead of all 256 — the dirty set, not the inventory, bounds
    the per-pass copy cost.  Layers compose: projected/preemption shadows
    stack another ShadowNodes on top of the pass's working view.
    """
    __slots__ = ("_base", "_names", "_dirty")

    def __init__(self, base, names=None):
        self._base = base                   # dict[str, Node] or ShadowNodes
        self._names = set(names) if names is not None else None
        self._dirty: dict[str, Node] = {}

    def __getitem__(self, name: str) -> Node:
        node = self._dirty.get(name)
        return node if node is not None else self._base[name]

    def __contains__(self, name: str) -> bool:
        if self._names is not None:
            return name in self._names
        return name in self._dirty or name in self._base

    def mutate(self, name: str) -> Node:
        """The node's private clone, created on first touch."""
        node = self._dirty.get(name)
        if node is None:
            node = self._base[name].clone()
            self._dirty[name] = node
        return node

    @property
    def dirty_count(self) -> int:
        return len(self._dirty)


@dataclass(frozen=True)
class Reservation:
    job_id: int
    start: float
    nodes: tuple[str, ...]


@dataclass(frozen=True)
class Preemption:
    """Evict ``victims`` so ``job_id`` can start."""
    job_id: int
    victims: tuple[int, ...]


@dataclass(frozen=True)
class Decision:
    """One scheduling pass outcome."""
    starts: tuple[tuple[int, tuple[str, ...]], ...]  # (job_id, nodes)
    reservations: tuple[Reservation, ...]
    preemptions: tuple[Preemption, ...] = ()
    holds: tuple[tuple[int, str], ...] = ()          # (job_id, reason)


def _rect_candidates(nodes: list[Node], count: int):
    """All host-grid rectangles of exactly `count` nodes from `nodes`.

    Nodes without coordinates fall back to arbitrary combinations (non-TPU
    partitions).  Yields tuples of node names.
    """
    coords = {n.coord: n for n in nodes if n.coord is not None}
    if not coords or len(coords) < count:
        if len(nodes) >= count:
            yield tuple(n.name for n in nodes[:count])
        return
    rows = sorted({c[0] for c in coords})
    cols = sorted({c[1] for c in coords})
    # factor pairs h x w == count
    for h in range(1, count + 1):
        if count % h:
            continue
        w = count // h
        for r0 in rows:
            for c0 in cols:
                rect = [(r0 + dr, c0 + dc)
                        for dr in range(h) for dc in range(w)]
                if all(rc in coords for rc in rect):
                    yield tuple(coords[rc].name for rc in rect)


def find_allocation(job: Job, nodes: dict[str, Node],
                    partition: Partition) -> Optional[tuple[str, ...]]:
    """Nodes that can run `job` right now, or None."""
    req = job.req
    avail = [
        nodes[nm] for nm in partition.nodes
        if nodes[nm].fits(req.cpus_per_node, req.mem_mb_per_node,
                          req.gres_per_node)
    ]
    if len(avail) < req.nodes:
        return None
    if req.contiguous:
        for cand in _rect_candidates(avail, req.nodes):
            return cand
        return None
    return tuple(n.name for n in avail[:req.nodes])


def capacity_probe(nodes: dict[str, Node], partition: Partition,
                   req) -> int:
    """slurm_now-style idle-capacity probe: the largest node count a job
    shaped like ``req`` (per-node cpus/mem/gres, contiguity) could start
    with RIGHT NOW — no queueing, no preemption, no reservations.

    This is the autoscaler's growth signal ("largest scavenger job that
    starts immediately"): it answers *would one more replica start*,
    without submitting anything.  Contiguous requests go through the
    same mesh-rectangle placement real allocation uses, so a probe
    answer of ``n`` is a guarantee, not an estimate."""
    upper = sum(
        1 for nm in partition.nodes
        if nodes[nm].fits(req.cpus_per_node, req.mem_mb_per_node,
                          req.gres_per_node))
    for n in range(upper, 0, -1):
        shaped = replace(req, nodes=n)
        probe = Job(job_id=-1, name="capacity-probe", user="",
                    partition=partition.name, req=shaped)
        if find_allocation(probe, nodes, partition) is not None:
            return n
    return 0


def _projected_allocation(job: Job, nodes: dict[str, Node],
                          partition: Partition, running: list[Job],
                          now: float) -> Optional[Reservation]:
    """Earliest-start reservation from projected job-end releases."""
    # replay releases in end-time order on a copy-on-write shadow
    shadow = ShadowNodes(nodes, names=partition.nodes)
    events = sorted(
        ((j.start_time + j.runtime(), j.job_id, j) for j in running
         if j.start_time is not None),
        key=lambda t: t[:2])          # job_id tiebreak: Jobs don't order
    events = [(when, j) for when, _, j in events]
    # try now, then after each release
    t = now
    for when, ending in itertools.chain([(now, None)], events):
        if ending is not None:
            for nm in ending.nodes_alloc:
                if nm in shadow:
                    shadow.mutate(nm).release(
                        ending.job_id, ending.req.cpus_per_node,
                        ending.req.mem_mb_per_node, ending.req.gres_per_node)
            t = when
        alloc = find_allocation(job, shadow, partition)
        if alloc is not None:
            return Reservation(job.job_id, t, alloc)
    return None


def _preemption_victims(job: Job, work: dict[str, Node],
                        partition: Partition, running: list[Job],
                        qos_table: dict[str, QOS],
                        rank: Callable[[Job], tuple],
                        ) -> Optional[tuple[int, ...]]:
    """Lowest-priority running jobs whose eviction lets ``job`` start.

    Greedy: evict candidates cheapest-first on a shadow state until the
    allocation fits, then drop any victim whose nodes turned out not to be
    needed.  Returns None when no victim set makes room.
    """
    my_qos = qos_table.get(job.qos)
    if my_qos is None or not my_qos.preempt:
        return None
    part_nodes = set(partition.nodes)
    candidates = [r for r in running
                  if my_qos.can_preempt(r.qos)
                  and any(nm in part_nodes for nm in r.nodes_alloc)]
    if not candidates:
        return None
    candidates.sort(key=rank, reverse=True)       # worst-ranked first
    shadow = ShadowNodes(work, names=partition.nodes)
    evicted: list[Job] = []
    for victim in candidates:
        for nm in victim.nodes_alloc:
            if nm in shadow:
                shadow.mutate(nm).release(
                    victim.job_id, victim.req.cpus_per_node,
                    victim.req.mem_mb_per_node, victim.req.gres_per_node)
        evicted.append(victim)
        alloc = find_allocation(job, shadow, partition)
        if alloc is not None:
            needed = set(alloc)
            kept = tuple(v.job_id for v in evicted
                         if needed & set(v.nodes_alloc))
            return kept or tuple(v.job_id for v in evicted[-1:])
    return None


def _grp_tres_usage(running: list[Job]) -> dict[tuple[str, str], dict]:
    """(qos, account) -> aggregate TRES held by running jobs."""
    usage: dict[tuple[str, str], dict] = {}
    for j in running:
        add_tres(usage.setdefault((j.qos, j.account), {}), job_tres(j.req))
    return usage


def schedule_pass(now: float, pending: list[Job], running: list[Job],
                  nodes: dict[str, Node], partitions: dict[str, Partition],
                  mode: str = "easy",
                  priority_fn: Optional[Callable[[Job], float]] = None,
                  qos_table: Optional[dict[str, QOS]] = None,
                  preemption_enabled: bool = True,
                  tracer=None) -> Decision:
    """One scheduling cycle.  Mutates nothing; returns the decision."""
    assert mode in ("easy", "conservative", "fifo")
    qos_table = qos_table or {}
    sp = tracer.begin("schedule_pass", cat="scheduler",
                      track=("cluster:scheduler", "passes"), ts=now,
                      mode=mode, pending=len(pending),
                      running=len(running)) if tracer is not None else None

    def rank(j: Job) -> tuple:
        """Ascending sort => best job first."""
        tier = partitions[j.partition].priority_tier if j.partition in \
            partitions else 0
        if priority_fn is not None:
            return (-tier, -priority_fn(j), j.submit_time, j.job_id)
        return (-tier,) + j.sort_key()

    queue = sorted((j for j in pending if j.state == JobState.PENDING
                    and j.reason != "Dependency"), key=rank)

    starts: list[tuple[int, tuple[str, ...]]] = []
    reservations: list[Reservation] = []
    preemptions: list[Preemption] = []
    holds: list[tuple[int, str]] = []
    # copy-on-write working view so successive starts see earlier ones
    # without cloning the whole inventory (dirty-set incremental clone)
    work = ShadowNodes(nodes)
    run_proj = list(running)
    grp_usage = _grp_tres_usage(running)

    for job in queue:
        part = partitions[job.partition]
        qos = qos_table.get(job.qos)
        my_tres = job_tres(job.req)
        if qos is not None and qos.grp_tres:
            held = grp_usage.get((job.qos, job.account), {})
            if not tres_within(held, my_tres, qos.grp_tres):
                holds.append((job.job_id, "QOSGrpResourceLimit"))
                continue                 # held: never backfills or preempts
        alloc = find_allocation(job, work, part)
        if alloc is not None:
            # backfill guard: starting now must not delay any reservation
            end = now + job.runtime()
            conflict = any(
                end > r.start and set(alloc) & set(r.nodes)
                for r in reservations)
            if not conflict:
                starts.append((job.job_id, alloc))
                for nm in alloc:
                    work.mutate(nm).allocate(
                        job.job_id, job.req.cpus_per_node,
                        job.req.mem_mb_per_node, job.req.gres_per_node)
                add_tres(grp_usage.setdefault((job.qos, job.account), {}),
                         my_tres)
                # projected running job for later reservations
                proj = copy.copy(job)
                proj.start_time = now
                proj.nodes_alloc = alloc
                run_proj.append(proj)
                continue
        if (preemption_enabled and not preemptions
                and qos is not None and qos.preempt):
            victims = _preemption_victims(job, work, part, running,
                                          qos_table, rank)
            if victims:
                preemptions.append(Preemption(job.job_id, victims))
                continue            # engine applies eviction + new pass
        if mode == "fifo":
            break                       # strict FIFO: head blocks the queue
        if mode == "easy" and reservations:
            continue                    # EASY: only the first blocked job
        res = _projected_allocation(job, work, part, run_proj, now)
        if res is not None:
            reservations.append(res)

    decision = Decision(tuple(starts), tuple(reservations),
                        tuple(preemptions), tuple(holds))
    if sp is not None:
        # virtual-clock spans are zero-length on the timeline; the
        # decision counts ride along as attributes
        tracer.end(sp, ts=now, starts=len(starts),
                   reservations=len(reservations),
                   preemptions=len(preemptions), holds=len(holds))
    return decision
