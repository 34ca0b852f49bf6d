"""DeepOps-style provisioning (paper §4): declarative inventory -> cluster,
plus the validation suite (our ``slurm-validation.yml``).

The Ansible inventory file of §4.2 becomes :class:`ClusterSpec`; running
``provision()`` "deploys" the software-defined cluster; ``validate()``
is the analogue of ``ansible-playbook ... slurm-validation.yml`` — it checks
connectivity (every node reachable = present & not DOWN), GRES visibility
(the `nvidia-smi` check of §5.2.2 becomes a per-node gres probe), and runs a
canary job through the scheduler end-to-end.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from repro_torch.cluster.cluster import Cluster
from repro_torch.cluster.job import JobState, ResourceRequest
from repro_torch.cluster.node import Node, NodeState, Partition


@dataclass(frozen=True)
class HostSpec:
    """One inventory line: hostname + resources (+ TPU grid coordinate)."""
    name: str
    cpus: int = 16
    mem_mb: int = 131_072
    gres: tuple[tuple[str, int], ...] = (("tpu", 4),)
    coord: tuple[int, int] | None = None


@dataclass(frozen=True)
class PartitionSpec:
    name: str
    hosts: tuple[str, ...]
    max_time_s: int = 24 * 3600
    priority_tier: int = 1
    default: bool = False


@dataclass(frozen=True)
class ClusterSpec:
    """The whole inventory (config/inventory in DeepOps terms)."""
    name: str
    hosts: tuple[HostSpec, ...]
    partitions: tuple[PartitionSpec, ...]
    slurm_enable_ha: bool = False
    sched_mode: str = "easy"


def tpu_pod_spec(name: str = "v5e-pod", hosts_x: int = 8, hosts_y: int = 8,
                 chips_per_host: int = 4, **kw) -> ClusterSpec:
    """A single TPU v5e pod: hosts_x*hosts_y hosts x 4 chips = 16x16 chips.

    Host (r, c) owns the 2x2 chip block at chip coords (2r..2r+1, 2c..2c+1).
    """
    hosts = tuple(
        HostSpec(name=f"tpu-{r:02d}-{c:02d}", gres=(("tpu", chips_per_host),),
                 coord=(r, c))
        for r in range(hosts_x) for c in range(hosts_y))
    parts = (
        PartitionSpec("batch", tuple(h.name for h in hosts), default=True),
        PartitionSpec("interactive", tuple(h.name for h in hosts[:8]),
                      max_time_s=4 * 3600, priority_tier=2),
    )
    return ClusterSpec(name=name, hosts=hosts, partitions=parts, **kw)


def provision(spec: ClusterSpec, real_mode: bool = False) -> Cluster:
    """Deploy: inventory -> Cluster (the ansible-playbook step of §4.2)."""
    nodes = [
        Node(name=h.name, cpus=h.cpus, mem_mb=h.mem_mb,
             gres=dict(h.gres), coord=h.coord)
        for h in spec.hosts
    ]
    partitions = [
        Partition(p.name, p.hosts, p.max_time_s, p.priority_tier, p.default)
        for p in spec.partitions
    ]
    return Cluster(nodes, partitions, sched_mode=spec.sched_mode,
                   real_mode=real_mode)


@dataclass
class ValidationReport:
    ok: bool
    checks: list = field(default_factory=list)

    def add(self, name: str, ok: bool, detail: str = ""):
        self.checks.append((name, ok, detail))
        self.ok = self.ok and ok

    def __str__(self):
        lines = [f"[{'ok' if ok else 'FAIL'}] {name}"
                 + (f" — {d}" if d else "")
                 for name, ok, d in self.checks]
        lines.append(f"validation: {'PASSED' if self.ok else 'FAILED'}")
        return "\n".join(lines)


def validate(cluster: Cluster, spec: ClusterSpec) -> ValidationReport:
    """slurm-validation.yml: reachability, GRES, partition sanity, canary."""
    rep = ValidationReport(ok=True)

    missing = [h.name for h in spec.hosts if h.name not in cluster.nodes]
    rep.add("inventory: all hosts registered", not missing,
            f"missing={missing}" if missing else f"{len(spec.hosts)} hosts")

    down = [n.name for n in cluster.nodes.values()
            if n.state == NodeState.DOWN]
    rep.add("connectivity: no DOWN nodes", not down, ",".join(down))

    bad_gres = [
        (h.name, g) for h in spec.hosts for g, c in h.gres
        if cluster.nodes.get(h.name) is not None
        and cluster.nodes[h.name].gres.get(g, 0) != c
    ]
    rep.add("gres: every host exposes its accelerators", not bad_gres,
            str(bad_gres) if bad_gres else "")

    orphans = [p.name for p in cluster.partitions.values() if not p.nodes]
    rep.add("partitions: none empty", not orphans, ",".join(orphans))

    # canary job per partition (the §5.2.2 `srun nvidia-smi` analogue),
    # asking for one accelerator of the kind the partition's first host
    # carries: gres/tpu on a TPU pod, gres/gpu on a GPU host
    for p in cluster.partitions.values():
        kind = next(iter(cluster.nodes[p.nodes[0]].gres), None)
        jid = cluster.submit(
            f"validate-{p.name}",
            ResourceRequest(nodes=1,
                            gres_per_node={kind: 1} if kind else {},
                            time_limit_s=60),
            partition=p.name, run_time_s=1.0)[0]
        for _ in range(10_000):
            if cluster.jobs[jid].state.finished or not cluster.tick():
                break
        ok = cluster.jobs[jid].state == JobState.COMPLETED
        rep.add(f"canary job on partition {p.name}", ok,
                cluster.jobs[jid].state.name)
    return rep
