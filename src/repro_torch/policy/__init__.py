"""Engine-agnostic multi-tenancy policy: the account tree, TRES usage
ledger, QOS tiers, and multifactor priority that both the batch scheduler
(`repro.cluster` in the JAX package) and the serving admission controller (`repro_torch.serving`)
consult.

Dependency rule: this package imports nothing from ``repro.cluster`` or
``repro_torch.serving`` — the dependency arrow points inward only.  Jobs,
requests, and partitions are duck-typed (``req.nodes``,
``partition.priority_tier``, ...), so any execution engine can bring its
own workload type and still share one ledger.

Layout (one concern per module):

* :mod:`repro_torch.policy.accounts` — the sacctmgr association tree (accounts,
  shares, users, normalized shares);
* :mod:`repro_torch.policy.usage` — the decayed TRES usage ledger
  (:class:`FairShareTree` = accounts + usage) with billing weights;
* :mod:`repro_torch.policy.priority` — SLURM's priority/multifactor composition
  around the classic ``2^(-usage/shares)`` fair-share factor;
* :mod:`repro_torch.policy.qos` — QOS tiers: priority boosts, GrpTRES caps,
  preemption rules, and the TRES vector helpers.
"""
from repro_torch.policy.accounts import Account, AccountTree
from repro_torch.policy.priority import (
    MultifactorPriority, PriorityBreakdown, PriorityWeights,
)
from repro_torch.policy.qos import (
    GrpTresLedger, PREEMPT_CANCEL, PREEMPT_REQUEUE, QOS, add_tres,
    default_qos_table, format_tres, job_tres, tres_within,
)
from repro_torch.policy.usage import DEFAULT_TRES_WEIGHTS, FairShareTree

__all__ = [
    "Account", "AccountTree", "DEFAULT_TRES_WEIGHTS", "FairShareTree",
    "GrpTresLedger", "MultifactorPriority", "PREEMPT_CANCEL",
    "PREEMPT_REQUEUE",
    "PriorityBreakdown", "PriorityWeights", "QOS", "add_tres",
    "default_qos_table", "format_tres", "job_tres", "tres_within",
]
