"""Software-defined SLURM/DeepOps cluster: inventory, scheduler, job
lifecycle, SLURM command surface, provisioning + validation, the
allocation -> device-grid bridge (``meshbridge``), and the multi-tenant
policy layer (accounts, fair-share, QOS, preemption).

The port of the JAX package's ``cluster`` package: every module but
``meshbridge`` is the same code with its imports rewritten, so the same
events give the same command text and accounting records.  A GPU host is
data: ``HostSpec("gpu-00", gres=(("gpu", n),))`` with no coordinates."""
from repro_torch.cluster.cluster import AccountingRecord, Cluster
from repro_torch.cluster.fairshare import (
    Account, FairShareTree, MultifactorPriority, PriorityWeights,
)
from repro_torch.cluster.job import (
    Dependency, DependencyKind, JOB_KIND_SERVE_REPLICA, Job, JobState,
    ResourceRequest,
)
from repro_torch.cluster.node import Node, NodeState, Partition
from repro_torch.cluster.provision import (
    ClusterSpec, HostSpec, PartitionSpec, provision, tpu_pod_spec, validate,
)
from repro_torch.cluster.qos import QOS, default_qos_table
from repro_torch.cluster import commands

__all__ = [
    "Account", "AccountingRecord", "Cluster", "Dependency", "DependencyKind",
    "FairShareTree", "JOB_KIND_SERVE_REPLICA", "Job", "JobState",
    "MultifactorPriority",
    "PriorityWeights", "QOS", "ResourceRequest", "Node", "NodeState",
    "Partition", "ClusterSpec", "HostSpec", "PartitionSpec",
    "default_qos_table", "provision", "tpu_pod_spec", "validate", "commands",
]
