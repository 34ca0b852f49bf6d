"""Prefix-affinity router over N decode-engine replicas.

One serving engine is one node's worth of HBM; the cluster has many.
This module is the front door of the elastic tier: a :class:`Router`
that owns N :class:`~repro_torch.serving.engine.DecodeEngine` replicas and
decides, per request, which replica's queue it joins.

* **Global admission, local execution** — every replica gets its own
  ``AdmissionController`` (slots and pages are physical, per-engine),
  but all of them bill the *same* :class:`~repro_torch.policy.FairShareTree`
  and, by default, the same :class:`~repro_torch.policy.GrpTresLedger`.  A
  tenant burning tokens on replica 0 loses priority on replica 1 too,
  and a GrpTRES slot cap is a cluster-wide cap, not per-replica × N.
* **Prefix affinity** — the radix prefix cache (``serving/prefix.py``)
  indexes prompts by complete ``page_size``-token blocks, so the
  request's *first complete prompt page* is exactly the key under which
  its system prompt would be cached.  The router consistent-hashes that
  key (:class:`HashRing`, SHA-1, ~64 virtual nodes per replica) so all
  requests sharing a system prompt land on the replica that already
  holds those pages.  Consistent hashing makes replica churn cheap:
  removing a replica remaps only *its* keys (property-tested).
* **Load shed** — affinity must not defeat batching: when the affine
  replica's queue depth exceeds the least-loaded replica's by more than
  ``spill_factor × num_slots``, the request spills to the least-loaded
  replica (counted in ``route_spills_total``; a cold prefill beats
  waiting out a convoy).
* **Drain** — :meth:`remove_replica` evicts every in-flight request via
  the engine's preemption path (partial output retained), pops the
  queues, and re-routes everything through the surviving ring.  Greedy
  decode is batch-independent, so a drained request's final output is
  bit-identical to an undisturbed run — the autoscaler leans on this.

The router never touches the device: it is host-side placement over
engines that each own their KV pool and radix index.

* **One stream** — replicas that share a card share its decode kernels'
  counter buffer (``kernels/flash_decode.py::_counters``, one per
  device), which is safe only while launches run in stream order:
  :meth:`Router.step` steps the replicas one after another on the
  current stream, and no replica may be given a stream of its own.
"""
from __future__ import annotations

import bisect
import hashlib
import itertools
import time
from dataclasses import dataclass, field

from repro_torch.monitoring.metrics import (
    METRIC_ROUTE_AFFINITY_HITS, METRIC_ROUTE_SPILLS,
    METRIC_SERVE_REPLICA_KV_PAGES, METRIC_SERVE_REPLICA_LOAD,
    MetricsRegistry,
)
from repro_torch.policy import FairShareTree, GrpTresLedger, \
    default_qos_table
from repro_torch.serving.admission import AdmissionController

#: affinity key length when a replica engine has no paged pool to take a
#: page size from (first complete "page" of the prompt is still a stable
#: shared-system-prompt key)
DEFAULT_KEY_TOKENS = 16


def affinity_key(prompt, page_size: int) -> bytes:
    """The routing key: the request's first complete prompt page — the
    same token block the radix index would cache it under — or the whole
    prompt when it is shorter than one page."""
    head = [int(t) for t in prompt[:page_size]]
    return ",".join(str(t) for t in head).encode()


class HashRing:
    """Deterministic consistent-hash ring (SHA-1; ``hash()`` is salted
    per-process and would break cross-run routing stability).

    Each replica owns ``vnodes`` points on a 64-bit ring; a key maps to
    the first point clockwise.  With ~64 virtual nodes per replica the
    per-replica key share stays within 2x of uniform, and removing a
    replica hands *only its own* arcs to the survivors.
    """

    def __init__(self, vnodes: int = 64):
        assert vnodes >= 1
        self.vnodes = vnodes
        self._ring: list[tuple[int, int]] = []   # sorted (point, rid)
        self._points: dict[int, list[int]] = {}  # rid -> its points

    @staticmethod
    def _digest(data: bytes) -> int:
        return int.from_bytes(hashlib.sha1(data).digest()[:8], "big")

    def add(self, rid: int):
        assert rid not in self._points
        points = [self._digest(f"replica-{rid}-vnode-{v}".encode())
                  for v in range(self.vnodes)]
        self._points[rid] = points
        for p in points:
            bisect.insort(self._ring, (p, rid))

    def remove(self, rid: int):
        for p in self._points.pop(rid):
            self._ring.remove((p, rid))

    def lookup(self, key: bytes) -> int:
        assert self._ring, "hash ring is empty"
        h = self._digest(key)
        i = bisect.bisect_right(self._ring, (h, -1))
        if i == len(self._ring):
            i = 0
        return self._ring[i][1]

    @property
    def replicas(self) -> list[int]:
        return sorted(self._points)

    def __len__(self) -> int:
        return len(self._points)


@dataclass
class Replica:
    """One engine plus its per-replica admission controller."""
    rid: int
    engine: object
    admission: AdmissionController
    busy_s: float = field(default=0.0)  # seconds spent inside step()


class Router:
    """Prefix-affinity front door over replica decode engines.

    ``make_engine(admission)`` is the replica factory: it must build a
    fresh ``DecodeEngine`` wired to the given admission controller (the
    router constructs one per replica against the shared ledger).  On a
    card, pass every replica the same weights already cast to the compute
    dtype, so that they share one weight set.
    ``policy`` is ``"affinity"`` (consistent-hash + spill), ``"rr"``
    (round-robin), or ``"least"`` (least-loaded).  ``grp_scope`` decides
    whether GrpTRES caps bind cluster-wide (``"global"``, one shared
    :class:`GrpTresLedger`) or per replica (``"replica"``, PR-4
    behaviour times N).
    """

    POLICIES = ("affinity", "rr", "least")

    def __init__(self, make_engine, replicas: int = 0,
                 policy: str = "affinity", spill_factor: float = 2.0,
                 tree: FairShareTree = None, qos_table: dict = None,
                 weights=None, metrics: MetricsRegistry = None,
                 grp_scope: str = "global", vnodes: int = 64):
        assert policy in self.POLICIES, policy
        assert grp_scope in ("global", "replica"), grp_scope
        self.make_engine = make_engine
        self.policy = policy
        self.spill_factor = spill_factor
        self.tree = tree if tree is not None else FairShareTree()
        self.qos_table = (qos_table if qos_table is not None
                          else default_qos_table())
        self.weights = weights
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self.grp_ledger = GrpTresLedger() if grp_scope == "global" else None
        self.ring = HashRing(vnodes)
        self.replicas: dict[int, Replica] = {}
        self._next_rid = itertools.count()
        self._rr = itertools.count()
        self.stats = {"routed": 0, "affinity_hits": 0, "spills": 0,
                      "drains": 0, "resubmitted": 0}
        for _ in range(replicas):
            self.add_replica()

    # ------------------------------------------------------------ fleet ----
    def add_replica(self) -> int:
        """Bring up one replica against the shared ledger; returns its id."""
        rid = next(self._next_rid)
        admission = AdmissionController(
            tree=self.tree, qos_table=self.qos_table, weights=self.weights,
            grp_ledger=self.grp_ledger)
        engine = self.make_engine(admission)
        assert engine.admission is admission, \
            "make_engine must wire the provided admission controller"
        self.replicas[rid] = Replica(rid, engine, admission)
        self.ring.add(rid)
        return rid

    def remove_replica(self, rid: int) -> int:
        """Drain ``rid``: evict its in-flight requests (partial output
        retained), pop its queues, and re-route everything through the
        surviving replicas.  Returns the number of requests moved."""
        assert len(self.replicas) > 1, "cannot drain the last replica"
        rep = self.replicas.pop(rid)
        self.ring.remove(rid)
        drained = rep.engine.drain()
        self.stats["drains"] += 1
        for req in drained:
            self.submit(req)
            self.stats["resubmitted"] += 1
        return len(drained)

    def load(self, rid: int) -> int:
        """Queue depth of one replica: slot holders plus queued — the
        spill signal and the autoscaler's emptiest-replica criterion."""
        eng = self.replicas[rid].engine
        return eng.active() + eng.pending()

    @property
    def page_size(self) -> int:
        for rep in self.replicas.values():
            paging = getattr(rep.engine, "paging", None)
            if paging is not None:
                return paging.page_size
        return DEFAULT_KEY_TOKENS

    def add_tenant(self, name: str, shares: int = 1):
        """Pre-register a tenant's shares on the shared tree (replicas'
        controllers pick existing accounts up on first submit)."""
        if name not in self.tree.accounts:
            self.tree.add_account(name, shares=shares)

    # ---------------------------------------------------------- routing ----
    def route(self, req) -> int:
        """Pick a replica id for ``req`` without submitting it."""
        rids = sorted(self.replicas)
        assert rids, "router has no replicas"
        if len(rids) == 1:
            return rids[0]
        if self.policy == "rr":
            return rids[next(self._rr) % len(rids)]
        loads = {r: self.load(r) for r in rids}
        least = min(rids, key=lambda r: (loads[r], r))
        if self.policy == "least":
            return least
        rid = self.ring.lookup(affinity_key(req.prompt, self.page_size))
        bound = self.spill_factor * self.replicas[rid].engine.num_slots
        if loads[rid] - loads[least] > bound:
            self.stats["spills"] += 1
            self.metrics.counter(
                METRIC_ROUTE_SPILLS,
                "affinity routes shed to the least-loaded replica").inc()
            return least
        self.stats["affinity_hits"] += 1
        self.metrics.counter(
            METRIC_ROUTE_AFFINITY_HITS,
            "requests routed to their prefix-affine replica").inc()
        return rid

    def submit(self, req) -> int:
        """Route ``req`` and enqueue it on the chosen replica."""
        rid = self.route(req)
        self.stats["routed"] += 1
        self.replicas[rid].engine.submit(req)
        return rid

    # --------------------------------------------------------- stepping ----
    def step(self) -> int:
        """Step every replica once; returns total tokens emitted.

        Per-replica compute time is accumulated in ``Replica.busy_s``
        (wall seconds inside each engine's ``step()``).  Replicas share
        nothing, so a real deployment's wall clock is the *busiest*
        replica's compute time — ``max(busy_s)`` is the router-balance
        throughput denominator the bench gates."""
        total = 0
        for rid in sorted(self.replicas):
            rep = self.replicas[rid]
            t0 = time.perf_counter()
            total += rep.engine.step()
            rep.busy_s += time.perf_counter() - t0
        self._update_gauges()
        return total

    def run_to_completion(self, max_steps: int = 10_000) -> int:
        total = 0
        for _ in range(max_steps):
            made = self.step()
            total += made
            if made == 0 and not any(
                    self.load(r) for r in self.replicas):
                break
        return total

    def busy_seconds(self) -> dict[int, float]:
        return {rid: rep.busy_s for rid, rep in self.replicas.items()}

    def _update_gauges(self):
        load_g = self.metrics.gauge(
            METRIC_SERVE_REPLICA_LOAD,
            "per-replica queue depth (slot holders + queued)")
        pages_g = self.metrics.gauge(
            METRIC_SERVE_REPLICA_KV_PAGES,
            "per-replica KV pages with >= 1 holder")
        for rid in sorted(self.replicas):
            load_g.set(float(self.load(rid)), replica=str(rid))
            eng = self.replicas[rid].engine
            view = getattr(eng, "pool_view", None)
            if getattr(eng, "paging", None) is not None and view is not None:
                pages_g.set(float(max(view.in_use_vector())),
                            replica=str(rid))
