"""Compatibility shim — the tenancy layer moved to :mod:`repro_torch.policy`.

The account tree, TRES usage ledger, and multifactor priority engine are
engine-agnostic policy (the serving admission controller consults the same
ledger), so they live in ``repro_torch.policy.{accounts,usage,priority}`` now.
This module keeps the historical import path working::

    from repro_torch.cluster.fairshare import FairShareTree   # still fine
    from repro_torch.policy import FairShareTree              # preferred
"""
from repro_torch.policy.accounts import Account, AccountTree
from repro_torch.policy.priority import (
    MultifactorPriority, PriorityBreakdown, PriorityWeights,
)
from repro_torch.policy.usage import DEFAULT_TRES_WEIGHTS, FairShareTree

__all__ = [
    "Account", "AccountTree", "DEFAULT_TRES_WEIGHTS", "FairShareTree",
    "MultifactorPriority", "PriorityBreakdown", "PriorityWeights",
]
