"""QOS tiers: priority boosts, TRES limits, and preemption policy.

SLURM's Quality-of-Service layer (``sacctmgr show qos``) is what turns one
physical cluster into several virtual service classes.  Each QOS carries:

* ``priority`` — a boost folded into the multifactor priority;
* ``preempt`` — the set of QOS names whose running work this QOS may evict
  when it cannot otherwise start (SLURM ``Preempt=``).  The batch
  scheduler evicts whole jobs; the serving admission controller evicts
  decode slots — same rule, either engine;
* ``preempt_mode`` — how work *of this QOS* is treated when evicted
  (``requeue``: back to PENDING keeping checkpointed progress;
  ``cancel``: killed outright);
* ``grp_tres`` — GrpTRES-style cap on the TRES an *account* may hold
  concurrently through this QOS (e.g. scavenger capped at 16 TPUs/account,
  or a serving tenant capped at 2 decode slots);
* ``usage_factor`` — fair-share charge multiplier (scavenger cycles are
  discounted, mirroring SLURM ``UsageFactor``).

The default catalogue models the three tiers most LLM clusters run:
``high`` (paid/production, may preempt), ``normal``, and ``scavenger``
(free-for-all on idle capacity, first to be evicted).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

PREEMPT_REQUEUE = "requeue"
PREEMPT_CANCEL = "cancel"


@dataclass(frozen=True)
class QOS:
    """One named service tier."""
    name: str
    priority: int = 0                    # folded into multifactor priority
    preempt: tuple[str, ...] = ()        # QOS names this tier may evict
    preempt_mode: str = PREEMPT_REQUEUE  # how *this* tier's jobs are evicted
    grp_tres: dict = field(default_factory=dict)   # {"gres/tpu": 16} per acct
    max_wall_s: Optional[int] = None     # per-job wall cap (tighter of QOS
    usage_factor: float = 1.0            # fair-share charge multiplier

    def __post_init__(self):
        assert self.preempt_mode in (PREEMPT_REQUEUE, PREEMPT_CANCEL)
        assert self.usage_factor >= 0.0

    def can_preempt(self, victim_qos: str) -> bool:
        return victim_qos in self.preempt


def default_qos_table() -> dict[str, QOS]:
    """The stock high/normal/scavenger catalogue."""
    return {
        "high": QOS("high", priority=1000, preempt=("normal", "scavenger")),
        "normal": QOS("normal", priority=500, preempt=("scavenger",)),
        "scavenger": QOS("scavenger", priority=0, usage_factor=0.25,
                         preempt_mode=PREEMPT_REQUEUE),
    }


def job_tres(req, tres_weights: Optional[dict] = None) -> dict[str, float]:
    """A job's total TRES vector (across all its nodes).

    Keys follow sacctmgr syntax: ``cpu``, ``mem`` (MB), ``gres/<name>``.
    Duck-typed over any request carrying ``nodes`` / ``cpus_per_node`` /
    ``mem_mb_per_node`` / ``gres_per_node``.
    """
    out = {"cpu": float(req.cpus_per_node * req.nodes),
           "mem": float(req.mem_mb_per_node * req.nodes)}
    for g, n in req.gres_per_node.items():
        out[f"gres/{g}"] = float(n * req.nodes)
    return out


def tres_within(usage: dict, extra: dict, limit: dict) -> bool:
    """Would ``usage + extra`` stay under ``limit`` (only limited keys)?"""
    for key, cap in limit.items():
        if usage.get(key, 0.0) + extra.get(key, 0.0) > cap + 1e-9:
            return False
    return True


def add_tres(into: dict, tres: dict, scale: float = 1.0) -> dict:
    for key, amt in tres.items():
        into[key] = into.get(key, 0.0) + amt * scale
    return into


class GrpTresLedger:
    """Shared GrpTRES holdings across admission controllers.

    SLURM's GrpTRES caps bind at the *association*, not per slurmctld
    thread — a 2-slot scavenger cap means 2 slots on the whole cluster.
    With N serving replicas, each replica's admission controller tracks
    its own physical slots/pages; this ledger is the shared view they
    write through so `_over_cap` checks the account's total across every
    replica.  Holdings are keyed ``(account, qos)`` and clamped at zero
    (release after a drain must not go negative).

    Scope is the policy knob: the router wires ONE ledger into all
    replica controllers (``grp_scope="global"``); omit it and each
    controller falls back to its private per-replica counters —
    GrpTRES × N, the pre-elastic behaviour.
    """

    def __init__(self):
        self._held: dict[tuple[str, str], dict[str, float]] = {}

    def adjust(self, account: str, qos: str, tres: dict):
        held = self._held.setdefault((account, qos), {})
        for key, amt in tres.items():
            held[key] = max(held.get(key, 0.0) + amt, 0.0)

    def held(self, account: str, qos: str) -> dict[str, float]:
        return dict(self._held.get((account, qos), {}))


def format_tres(tres: dict) -> str:
    """``cpu=8,mem=8192M,gres/tpu=16`` (sacctmgr-style)."""
    parts = []
    for key in sorted(tres):
        v = tres[key]
        v = int(v) if float(v).is_integer() else round(v, 2)
        parts.append(f"{key}={v}M" if key == "mem" else f"{key}={v}")
    return ",".join(parts)
