"""Multi-tenant fair-share tour: two tenants share one partition.

The port's twin of ``examples/multi_tenant.py``: the same scenario on
``repro_torch.cluster``, printing what the JAX example prints, byte for
byte.  It shows the policy layer the paper's §3.2.3 "fairness policies"
line points at:

* ``sacctmgr`` account tree — ``prod`` (10 shares) vs ``research`` (1 share);
* QOS tiers — prod submits ``high``, research scavenges idle capacity with
  ``scavenger`` (which charges only 25% usage but is first to be evicted);
* preemption — a high job evicts the scavenger sweep; the victim requeues
  and, because it checkpoints every 300s (``ckpt_interval_s``), resumes
  from its last step instead of restarting;
* fair-share convergence — after prod burns TRES-seconds its fair-share
  factor 2^(-usage/shares) drops, so research's queued work rises in
  priority (``sshare`` / ``sprio`` make this visible).

The cluster runs on a simulated clock on the host; no job touches the
device, which is resolved all the same (``--device``, default the card,
as every entry point of the port).

Run on the card:  PYTHONPATH=src python examples/torch/multi_tenant.py
Run on the CPU:   PYTHONPATH=src python examples/torch/multi_tenant.py \\
                      --device cpu
"""
import argparse

from repro_torch.cluster import (
    ResourceRequest, commands, provision, tpu_pod_spec,
)
from repro_torch.device import resolve_device


def req(nodes, time_s=14_400):
    return ResourceRequest(nodes=nodes, gres_per_node={"tpu": 4},
                           time_limit_s=time_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no job here uses it")
    resolve_device(ap.parse_args(argv).device)

    cluster = provision(tpu_pod_spec(hosts_x=4, hosts_y=2))   # 8 hosts

    print("== sacctmgr: tenants and shares ==")
    print(commands.sacctmgr_add_account(cluster, "prod", fairshare=10))
    print(commands.sacctmgr_add_account(cluster, "research", fairshare=1))
    commands.sacctmgr_add_user(cluster, "alice", "prod")
    commands.sacctmgr_add_user(cluster, "bob", "research")
    print(commands.sacctmgr_show_assoc(cluster), "\n")
    print(commands.sacctmgr_show_qos(cluster), "\n")

    print("== research scavenges the idle pod ==")
    (sweep,) = cluster.submit("scavenge-sweep", req(nodes=8), user="bob",
                              qos="scavenger", run_time_s=7200,
                              ckpt_interval_s=300)
    print(commands.squeue(cluster), "\n")

    # let the sweep run 20 minutes before production shows up
    cluster.clock += 1200.0

    print("== prod's high-QOS train preempts the scavenger ==")
    (train,) = cluster.submit("prod-train", req(nodes=8), user="alice",
                              qos="high", run_time_s=3600)
    sj = cluster.jobs[sweep]
    print(f"prod-train: {cluster.jobs[train].state.name};  "
          f"sweep: {sj.state.name} (requeued x{sj.requeue_count}, "
          f"kept {sj.progress_s:.0f}s of checkpointed work)\n")

    print("== sprio while the sweep waits ==")
    print(commands.sprio(cluster), "\n")

    cluster.run()

    print("== sacct: both segments of the preempted sweep ==")
    print(commands.sacct(cluster), "\n")

    print("== sshare: usage charged, factors diverged ==")
    print(commands.sshare(cluster))
    print(f"\npreemptions: {cluster.preemptions_total}; "
          f"sweep finished at t={cluster.jobs[sweep].end_time:.0f}s "
          f"(saved {cluster.jobs[sweep].progress_s:.0f}s by resuming "
          f"from checkpoint)")


if __name__ == "__main__":
    main()
