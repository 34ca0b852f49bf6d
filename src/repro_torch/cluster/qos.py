"""Compatibility shim — QOS tiers moved to :mod:`repro_torch.policy.qos`.

QOS policy (priority boosts, GrpTRES caps, preemption rules) applies to
serving slots as much as to batch jobs, so it lives in the engine-agnostic
``repro_torch.policy`` package now.  This module keeps the historical import
path working::

    from repro_torch.cluster.qos import QOS, default_qos_table   # still fine
    from repro_torch.policy import QOS, default_qos_table        # preferred
"""
from repro_torch.policy.qos import (
    PREEMPT_CANCEL, PREEMPT_REQUEUE, QOS, add_tres, default_qos_table,
    format_tres, job_tres, tres_within,
)

__all__ = [
    "PREEMPT_CANCEL", "PREEMPT_REQUEUE", "QOS", "add_tres",
    "default_qos_table", "format_tres", "job_tres", "tres_within",
]
