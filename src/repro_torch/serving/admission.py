"""Multi-tenant admission for the decode engine: the serving half of the
shared tenancy core.

The batch scheduler (``repro.cluster`` in the JAX package) and this controller consult the
*same* ``repro_torch.policy`` machinery — one account tree, one decayed TRES
ledger, one QOS catalogue — so a single ``sshare`` call reports a tenant's
batch jobs *and* served tokens against one set of shares.

Per-tenant queues replace the engine's single deque.  *Within* a tenant
queue requests are ordered by ``(QOS priority desc, arrival seq)`` — a
high-QOS request never waits behind a same-tenant scavenger one (the
cross-tenant analogue has always held via preemption).  When a slot
frees, the next request comes from the tenant maximizing the same
multifactor composition the scheduler uses::

    W_fs * 2^(-usage/shares) + W_qos * qos_priority_norm

with FIFO arrival order breaking ties.  Serving consumption charges the
ledger in serving TRES units: generated tokens and KV-cache residency
(cache lines held per decode step), discounted by the QOS
``usage_factor`` exactly like batch scavenger cycles.  The fused decode
engine charges once per chunk through :meth:`charge_bulk`, which groups
by (tenant, QOS) so ledger writes stay O(tenants) per chunk no matter
the slot count.

With ``wall_clock_decay=True`` the shared ledger decays on
``time.monotonic()`` at every pick/charge — for long-lived pure-serving
deployments where no cluster event loop drives ``decay_to`` (otherwise
an old hog would never be forgiven).  Leave it off when the ledger is
shared with a simulated cluster clock.

QOS rules carry over unchanged:

* ``grp_tres`` — a tenant's concurrent decode slots are capped via the
  ``slots`` TRES key (``QOS(grp_tres={"slots": 2})``): the GrpTRES hold
  that keeps one tenant from monopolizing the batch;
* ``preempt`` — a queued high-QOS request that finds no free slot may
  evict one running preemptable (e.g. scavenger) slot; the victim
  requeues at the head of its tenant queue with its partial output
  retained and resumes from where it stopped.
"""
from __future__ import annotations

import bisect
import itertools
import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from repro_torch.policy import (
    FairShareTree, PriorityWeights, QOS, default_qos_table, tres_within,
)

#: Serving TRES billing weights, merged into the shared ledger's
#: TRESBillingWeights on attach (setdefault — an operator override wins).
#: One generated token bills like one accelerator-second; KV residency is
#: a light rent so long-context requests pay for the memory they pin.
SERVING_TRES_WEIGHTS = {
    "tokens": 1.0,            # one generated token
    "gres/kv_token": 0.001,   # one KV-cache line resident for one step
}
# "gres/kv_page" (one KV page resident for one step) is deliberately NOT
# defaulted here: its fair rate is page_size * kv_token, so the paged
# engine setdefaults it from its own page size at attach — an operator
# value set beforehand always wins, and engines sharing one ledger
# should share one page size (or set the weight explicitly).

#: TRES key for concurrent decode slots (GrpTRES caps, e.g. {"slots": 2}).
TRES_SLOTS = "slots"

#: TRES key for concurrently-held KV pages (paged engine GrpTRES caps,
#: e.g. ``{"kv_pages": 8}`` — a direct lid on a tenant's HBM residency).
TRES_KV_PAGES = "kv_pages"


@dataclass
class Tenant:
    """One serving tenant: an account in the shared tree + a queue kept
    sorted by (QOS priority desc, arrival seq)."""
    name: str
    shares: int = 1
    queue: list = field(default_factory=list)
    # decode slots currently held, keyed by QOS — GrpTRES caps are
    # per-(account, QOS), matching the batch scheduler's accounting
    slots_by_qos: dict = field(default_factory=dict)
    # KV pages currently held, keyed by QOS (paged engine only)
    pages_by_qos: dict = field(default_factory=dict)

    @property
    def slots_held(self) -> int:
        return sum(self.slots_by_qos.values())

    @property
    def pages_held(self) -> int:
        return sum(self.pages_by_qos.values())


class AdmissionController:
    """Per-tenant queues + fair-share pick + QOS caps/preemption.

    All bookkeeping is host-side Python over O(tenants) dicts — nothing
    here touches the jitted decode path.
    """

    def __init__(self, tree: Optional[FairShareTree] = None,
                 qos_table: Optional[dict[str, QOS]] = None,
                 weights: Optional[PriorityWeights] = None,
                 wall_clock_decay: bool = False,
                 clock=time.monotonic, tracer=None, grp_ledger=None):
        self.tree = tree if tree is not None else FairShareTree()
        for key, w in SERVING_TRES_WEIGHTS.items():
            self.tree.tres_weights.setdefault(key, w)
        if wall_clock_decay:
            self.tree.enable_wallclock_decay(clock)
        self.qos_table = dict(qos_table) if qos_table is not None \
            else default_qos_table()
        self.weights = weights or PriorityWeights()
        self.tenants: dict[str, Tenant] = {}
        self._seq = itertools.count()      # global FIFO arrival order
        #: optional repro_torch.monitoring.Tracer — QUEUED spans, queue-wait
        #: SLO series, and pick-reason attributes hang off it
        self.tracer = tracer
        #: optional shared repro_torch.policy.GrpTresLedger — when set, GrpTRES
        #: caps bind on the account's holdings across EVERY controller
        #: writing through the same ledger (the router's N replicas),
        #: not just this one's
        self.grp_ledger = grp_ledger
        #: optional predicate(req) -> bool: "would this request's prompt
        #: hit the radix prefix index right now?"  The engine wires it
        #: when the prefix cache is on; it breaks exact fair-share
        #: priority ties toward requests that reuse cached pages (their
        #: prefill is nearly free), falling back to FIFO within the tie.
        self.radix_probe = None
        #: admission cycle statistics, the `sdiag` admission section
        self.stats = {"cycles": 0, "picks": 0, "preempt_picks": 0,
                      "requeues": 0}

    # ----------------------------------------------------------- tenants ----
    def add_tenant(self, name: str, shares: int = 1) -> Tenant:
        """Register a tenant (idempotent).  Reuses an existing account in
        a shared tree — so a batch account and a serving tenant with the
        same name are literally the same ledger row.  For a pre-existing
        account the ledger's shares are authoritative (priorities come
        from ``tree.norm_shares``): the ``shares`` argument is ignored
        and the tenant reports the tree's value."""
        t = self.tenants.get(name)
        if t is not None:
            return t
        if name not in self.tree.accounts:
            self.tree.add_account(name, shares=shares)
        else:
            shares = self.tree.accounts[name].shares
        t = Tenant(name, shares=shares)
        self.tenants[name] = t
        return t

    # ------------------------------------------------------------ queues ----
    def _order_key(self, req):
        """In-queue ordering: highest QOS first, then arrival order."""
        qos = self.qos_table.get(req.qos)
        return (-(qos.priority if qos else 0), req._seq)

    def account_for(self, req) -> str:
        """The ledger account a request bills: its ``tenant/user`` leaf
        association when the request carries a user, else the tenant
        itself.  Leaf charges propagate up the subtree, so the tenant's
        standing still reflects all of its users."""
        user = getattr(req, "user", "")
        return f"{req.tenant}/{user}" if user else req.tenant

    def submit(self, req):
        """Enqueue a request on its tenant's queue — (QOS priority,
        arrival) ordered — auto-registering an unknown tenant with 1
        share, like the scheduler's lenient auto-association.  A request
        with a ``user`` additionally auto-registers its ``tenant/user``
        leaf association (idempotent), so per-user fair-share needs no
        pre-provisioning."""
        t = self.add_tenant(req.tenant)
        user = getattr(req, "user", "")
        if user:
            self.tree.add_user_association(user, req.tenant)
        req._seq = next(self._seq)
        bisect.insort(t.queue, req, key=self._order_key)
        self._trace_enqueue(req)

    def requeue(self, req):
        """A preempted request goes back into its tenant's queue with
        partial output retained.  Its original arrival seq makes it first
        in line within its QOS class when capacity returns (a later,
        higher-QOS arrival may still outrank it — by design)."""
        bisect.insort(self.tenants[req.tenant].queue, req,
                      key=self._order_key)
        self.stats["requeues"] += 1
        self._trace_enqueue(req, resumed=True)

    # ----------------------------------------------------------- tracing ----
    def _trace_enqueue(self, req, resumed: bool = False):
        """Open a QUEUED span for a (re)enqueued request: closed by the
        pick that admits it, its duration IS the queue wait."""
        tr = self.tracer
        if tr is None:
            return
        trace = getattr(req, "_trace", None)
        if trace is None:
            trace = req._trace = {}
        root = trace.get("root")
        track = root.track if root is not None else (
            f"serving:{req.tenant}", f"req {getattr(req, 'rid', '?')}")
        trace["queued"] = tr.begin("QUEUED", cat="queue", track=track,
                                   parent=root, resumed=resumed,
                                   qos=req.qos)

    def _trace_pick(self, req, reason: str):
        """Close the QUEUED span with the pick reason and feed the
        queue-wait SLO series (admit timestamp stamps the request — the
        engine's TTFT measurement starts here)."""
        self.stats["picks"] += 1
        if reason == "preemption":
            self.stats["preempt_picks"] += 1
        tr = self.tracer
        if tr is None:
            return
        now = tr.clock()
        req._t_admit = now
        trace = getattr(req, "_trace", None)
        queued = trace.pop("queued", None) if trace else None
        if queued is not None:
            wait = now - queued.start
            tr.end(queued, ts=now, pick_reason=reason,
                   fairshare=round(
                       self.tree.fair_share_factor(req.tenant), 4))
        else:
            wait = 0.0
        tr.slo.queue_wait(wait, req.tenant, req.qos)

    def pending(self) -> int:
        return sum(len(t.queue) for t in self.tenants.values())

    def queued(self, tenant: str) -> int:
        t = self.tenants.get(tenant)
        return len(t.queue) if t else 0

    # -------------------------------------------------------------- pick ----
    def _qos_factor(self, qos_name: str) -> float:
        qos = self.qos_table.get(qos_name)
        max_qos = max((q.priority for q in self.qos_table.values()),
                      default=1) or 1
        return qos.priority / max_qos if qos else 0.0

    def _priority(self, tenant: Tenant) -> float:
        """The serving multifactor: fair-share + QOS, same weights and the
        same ``2^(-usage/shares)`` factor the batch scheduler uses.  The
        fair-share factor is the head request's LEAF association — its
        ``tenant/user`` sub-account when it has one — so two users of
        the same tenant fair-share against each other, not just against
        other tenants."""
        head = tenant.queue[0]
        return (self.weights.fairshare
                * self.tree.fair_share_factor(self.account_for(head))
                + self.weights.qos * self._qos_factor(head.qos))

    def _over_cap(self, tenant: Tenant, req) -> bool:
        qos = self.qos_table.get(req.qos)
        if qos is None or not qos.grp_tres:
            return False
        if self.grp_ledger is not None:
            # global scope: the account's holdings summed across every
            # replica controller sharing this ledger
            total = self.grp_ledger.held(req.tenant, req.qos)
            held = {TRES_SLOTS: total.get(TRES_SLOTS, 0.0),
                    TRES_KV_PAGES: total.get(TRES_KV_PAGES, 0.0)}
        else:
            held = {TRES_SLOTS: float(tenant.slots_by_qos.get(req.qos, 0)),
                    TRES_KV_PAGES: float(tenant.pages_by_qos.get(
                        req.qos, 0))}
        # _est_pages: the paged engine stamps its page estimate on submit;
        # dense mode leaves it 0 so only the slot cap binds.  Under TP the
        # estimate may arrive as a per-shard vector (one logical page =
        # one page slice per shard); the cap binds on the tightest shard
        ask = {TRES_SLOTS: 1.0,
               TRES_KV_PAGES: float(np.max(getattr(req, "_est_pages", 0)))}
        return not tres_within(held, ask, qos.grp_tres)

    def _best_tenant(self, eligible=None) -> Optional[Tenant]:
        self.tree.tick()                   # wall-clock decay, if enabled
        best, best_key = None, None
        for t in self.tenants.values():
            if not t.queue or self._over_cap(t, t.queue[0]):
                continue
            if eligible is not None and not eligible(t.queue[0]):
                continue
            key = (self._priority(t), self._radix_bit(t.queue[0]),
                   -t.queue[0]._seq)
            if best is None or key > best_key:
                best, best_key = t, key
        return best

    def _radix_bit(self, req) -> int:
        """Tie-break between tenants whose multifactor priorities are
        exactly equal: prefer the head whose prompt hits the radix
        prefix index (its prefill is mostly cached — admitting it first
        is nearly free and keeps the shared pages hot).  Probe unset
        (no prefix cache) degrades to the pure FIFO tie-break."""
        if self.radix_probe is None:
            return 0
        return 1 if self.radix_probe(req) else 0

    def next_request(self, eligible=None):
        """Pop the next request to admit, or None (all queues empty or
        capped).  The caller owns the slot; the tenant's GrpTRES slot
        hold is taken here and returned by :meth:`release`.

        ``eligible`` (optional predicate over the head request) lets the
        engine veto picks it cannot place right now — the paged engine
        passes "does the prefill fit the free page pool", so a big
        blocked request does not starve admissible small ones.
        """
        self.stats["cycles"] += 1
        t = self._best_tenant(eligible=eligible)
        if t is None:
            return None
        req = t.queue.pop(0)
        t.slots_by_qos[req.qos] = t.slots_by_qos.get(req.qos, 0) + 1
        self._ledger_adjust(req, slots=1.0)
        self._trace_pick(req, "fairshare")
        return req

    def release(self, req):
        """Return the slot hold (request finished or was evicted)."""
        t = self.tenants.get(req.tenant)
        if t is not None:
            t.slots_by_qos[req.qos] = max(
                t.slots_by_qos.get(req.qos, 0) - 1, 0)
            self._ledger_adjust(req, slots=-1.0)

    def _ledger_adjust(self, req, slots: float = 0.0, pages: float = 0.0):
        """Mirror a holdings change into the shared GrpTRES ledger (when
        global scope is on) so sibling controllers see it."""
        if self.grp_ledger is None:
            return
        self.grp_ledger.adjust(req.tenant, req.qos,
                               {TRES_SLOTS: slots, TRES_KV_PAGES: pages})

    def adjust_pages(self, req, delta: int):
        """Track a tenant's reserved KV pages for the ``kv_pages``
        GrpTRES cap.  The classic paged engine reserves a request's
        WORST-CASE footprint (``_est_pages``) for its whole slot
        residency and returns it on finish/evict — decode-time growth is
        pre-paid, so a tenant can never grow past its cap.  The budgeted
        engine (``max_batch_tokens``) instead moves the hold
        chunk-by-chunk as a partial prefill's pages actually materialize
        (TRUE holdings, returned in full on promotion-exit, preemption,
        or starvation), so mid-prefill requests occupy exactly what they
        use.

        ``delta`` may be a per-shard vector (TP engines): the ledger
        tracks the tightest shard, since that is the shard the GrpTRES
        cap protects."""
        t = self.tenants.get(req.tenant)
        if t is not None:
            t.pages_by_qos[req.qos] = max(
                t.pages_by_qos.get(req.qos, 0) + int(np.max(delta)), 0)
            self._ledger_adjust(req, pages=float(int(np.max(delta))))

    # -------------------------------------------------------- preemption ----
    def pick_victim(self, candidates: list):
        """The ONE eviction-victim rule, shared by QOS preemption and the
        paged engine's pool-exhaustion reclaim: lowest QOS priority
        first, ties toward the worst fair-share standing, then the most
        recent admission.  Callers pass only candidates the preemptor's
        QOS may evict."""
        def vkey(r):
            vq = self.qos_table.get(r.qos)
            return (vq.priority if vq else 0,
                    self.tree.fair_share_factor(r.tenant), -r._seq)
        return min(candidates, key=vkey)

    def next_preempting(self, running: list):
        """Pop the best queued request whose QOS may evict one of
        ``running``, and pick its victim: ``(request, victim)`` or None.

        Atomic pop-and-pick so the engine admits exactly the blocked
        request the eviction was justified by (the requeued victim lands
        at the head of its tenant queue and must not race it back into
        the freed slot).  Considered tenants are those whose *head* can
        preempt something running — a blocked high request preempts even
        when a non-preempting tenant outranks it for the next free slot.
        The victim is the lowest-QOS running request, breaking ties
        toward the tenant with the worst fair-share standing, then the
        most recent admission.
        """
        running_qos = {r.qos for r in running}

        def can_preempt_now(req) -> bool:
            qos = self.qos_table.get(req.qos)
            return qos is not None and any(
                qos.can_preempt(v) for v in running_qos)

        self.stats["cycles"] += 1
        t = self._best_tenant(eligible=can_preempt_now)
        if t is None:
            return None
        head = t.queue[0]
        qos = self.qos_table[head.qos]
        victim = self.pick_victim(
            [r for r in running if qos.can_preempt(r.qos)])
        t.queue.pop(0)
        t.slots_by_qos[head.qos] = t.slots_by_qos.get(head.qos, 0) + 1
        self._ledger_adjust(head, slots=1.0)
        self._trace_pick(head, "preemption")
        return head, victim

    # ---------------------------------------------------------- charging ----
    def charge(self, req, tokens: int = 0, kv_tokens: int = 0,
               kv_pages: float = 0) -> float:
        """Charge generated tokens and/or KV-cache residency to the
        request's tenant in the shared ledger (QOS usage_factor applied,
        so scavenger tokens are discounted like scavenger job-seconds).
        Dense engines bill residency in ``kv_tokens`` (lines x steps);
        the paged engine bills ``kv_pages`` (pages x steps) — actual HBM
        held, so a short request stops paying for cache it never pinned.
        ``kv_pages`` may be fractional: a prefix-cache page shared by N
        live requests bills ``1/N`` to each holder, so the pool's true
        residency is charged exactly once per step across all sharers.

        No decay advance unless ``wall_clock_decay`` was enabled: the
        ledger's clock is driven by whoever owns it (the cluster's event
        loop, ``tree.decay_to`` directly, or the wall clock when opted
        in).
        """
        self.tree.tick()
        qos = self.qos_table.get(req.qos)
        return self.tree.charge_tres(
            self.account_for(req),
            {"tokens": float(tokens), "gres/kv_token": float(kv_tokens),
             "gres/kv_page": float(kv_pages)},
            usage_factor=qos.usage_factor if qos else 1.0)

    def charge_bulk(self, charges) -> float:
        """Charge a chunk's worth of consumption in one pass: ``charges``
        is an iterable of ``(req, tokens, kv_tokens)`` or
        ``(req, tokens, kv_tokens, kv_pages)``.  Grouped by (tenant, QOS)
        before hitting the ledger, so the fused decode engine pays
        O(tenants) ledger writes per chunk regardless of slot count or
        chunk length.  Returns the total charged amount."""
        self.tree.tick()
        grouped: dict[tuple, list[float]] = {}
        for entry in charges:
            req, tokens, kv_tokens = entry[0], entry[1], entry[2]
            kv_pages = entry[3] if len(entry) > 3 else 0
            acc = grouped.setdefault((self.account_for(req), req.qos),
                                     [0.0, 0.0, 0.0])
            acc[0] += tokens
            acc[1] += kv_tokens
            acc[2] += kv_pages
        total = 0.0
        for (account, qos_name), (tokens, kv_tokens, kv_pages) in \
                grouped.items():
            qos = self.qos_table.get(qos_name)
            total += self.tree.charge_tres(
                account,
                {"tokens": tokens, "gres/kv_token": kv_tokens,
                 "gres/kv_page": kv_pages},
                usage_factor=qos.usage_factor if qos else 1.0)
        return total
