"""`python -m repro_torch.cluster.cli` — drive a demo cluster through the
guide's §5 workflow from the shell: provision, validate, submit, watch,
account.

A stateful daemon is out of scope for a CI container, so the CLI runs a
scripted run against a fresh software-defined pod — the point is that
every command from the paper's tables (sinfo/squeue/sbatch/srun/scancel/
scontrol/sacct) exists and produces SLURM-shaped output.
"""
from __future__ import annotations

import argparse

from repro_torch.cluster import commands as C
from repro_torch.cluster.provision import provision, tpu_pod_spec, validate


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.cluster")
    ap.add_argument("--hosts", type=int, default=8,
                    help="pod host-grid side (hosts = side^2)")
    ap.add_argument("--demo-jobs", type=int, default=6)
    args = ap.parse_args(argv)

    spec = tpu_pod_spec(hosts_x=args.hosts, hosts_y=args.hosts)
    cluster = provision(spec)
    print(f"== provisioned {spec.name}: {len(spec.hosts)} hosts ==")
    print(validate(cluster, spec))

    print("\n== sinfo ==")
    print(C.sinfo(cluster))

    print("\n== submitting demo jobs ==")
    print(C.sbatch(cluster, name="resnet-train", nodes=4, gres="tpu:4",
                   time="04:00:00", run_time_s=3600))
    print(C.sbatch(cluster, name="llm-pretrain", nodes=16, gres="tpu:4",
                   time="1-00:00:00", run_time_s=86_000, priority=10))
    print(C.sbatch(cluster, name="sweep", nodes=1, gres="tpu:4",
                   time="00:30:00", array=args.demo_jobs, run_time_s=600))
    print(C.sbatch(cluster, name="eval-after", nodes=2, gres="tpu:4",
                   time="01:00:00", dependency="afterok:2", run_time_s=300))

    print("\n== squeue ==")
    print(C.squeue(cluster))

    print("\n== scontrol show job 2 ==")
    print(C.scontrol_show_job(cluster, 2))

    print("\n== draining a node ==")
    print(C.scontrol_update_node(cluster, "tpu-00-00", "drain", "maintenance"))

    stuck = cluster.run()
    print(f"\n== queue drained (clock={cluster.clock:.0f}s, "
          f"stuck={stuck}) ==")

    print("\n== sacct ==")
    print(C.sacct(cluster))

    # ---- multi-tenant: accounts, QOS, fair-share, preemption (§3.2.3) ----
    print(C.scontrol_update_node(cluster, "tpu-00-00", "idle"))
    cluster.run()                       # drain the single-tenant backlog

    print("\n== sacctmgr: two tenants sharing the pod ==")
    print(C.sacctmgr_add_account(cluster, "prod", fairshare=10))
    print(C.sacctmgr_add_account(cluster, "research", fairshare=1))
    C.sacctmgr_add_user(cluster, "alice", "prod")
    C.sacctmgr_add_user(cluster, "bob", "research")
    print(C.sacctmgr_show_qos(cluster))

    print("\n== scavenger fills idle capacity; prod preempts ==")
    print(C.sbatch(cluster, name="bg-sweep", nodes=args.hosts ** 2,
                   gres="tpu:4", time="04:00:00", run_time_s=7200,
                   user="bob", qos="scavenger", ckpt_interval_s=600))
    print(C.sbatch(cluster, name="prod-train", nodes=args.hosts ** 2 // 2,
                   gres="tpu:4", time="02:00:00", run_time_s=1800,
                   user="alice", qos="high"))
    print(C.squeue(cluster))

    print("\n== sprio ==")
    print(C.sprio(cluster))

    cluster.run()
    print(f"\n== drained; {cluster.preemptions_total} preemption(s) ==")
    print("\n== sshare ==")
    print(C.sshare(cluster))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
