"""SLURM workflow tour: everything §5 of the guide demonstrates, live —
priorities, EASY backfill, dependencies (afterok/afternotok), job arrays,
node drain + requeue, and HA controller failover.

The port's twin of ``examples/slurm_workflow.py``: the same scenario on
``repro_torch.cluster``, printing what the JAX example prints, byte for
byte.  The cluster runs on a simulated clock on the host; no job touches
the device, which is resolved all the same (``--device``, default the
card, as every entry point of the port).

Run on the card:  PYTHONPATH=src python examples/torch/slurm_workflow.py
Run on the CPU:   PYTHONPATH=src python examples/torch/slurm_workflow.py \\
                      --device cpu
"""
import argparse

from repro_torch.cluster import (
    Cluster, JobState, NodeState, ResourceRequest, commands, provision,
    tpu_pod_spec,
)
from repro_torch.device import resolve_device


def req(nodes=1, time_s=3600):
    return ResourceRequest(nodes=nodes, gres_per_node={"tpu": 4},
                           time_limit_s=time_s)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; no job here uses it")
    resolve_device(ap.parse_args(argv).device)

    cluster = provision(tpu_pod_spec(hosts_x=4, hosts_y=2))   # 8 hosts

    print("== backfill (§3.2.3) ==")
    (long_,) = cluster.submit("long-train", req(nodes=4), run_time_s=3600)
    (head,) = cluster.submit("big-eval", req(nodes=8), priority=9,
                             run_time_s=600)
    (short,) = cluster.submit("short-probe", req(nodes=2, time_s=1800),
                              run_time_s=1200)
    print(commands.squeue(cluster))
    print(f"head of queue blocked -> reservation; short job backfilled: "
          f"{cluster.jobs[short].state.name}\n")

    print("== dependencies (§5.2) ==")
    (prep,) = cluster.submit("preprocess", req(), run_time_s=60)
    (train,) = cluster.submit("train", req(), dependency=f"afterok:{prep}",
                              run_time_s=120)
    (rescue,) = cluster.submit("rescue", req(),
                               dependency=f"afternotok:{train}",
                               run_time_s=30)
    print(commands.squeue(cluster))

    print("== job array (hyperparameter sweep) ==")
    arr = cluster.submit("sweep-lr", req(), array=4, run_time_s=300)
    print(f"submitted array {arr}\n")

    print("== drain + requeue (§6.3 maintenance) ==")
    victim = cluster.jobs[long_].nodes_alloc[0]
    commands.scontrol_update_node(cluster, victim, "down", reason="ECC")
    print(f"node {victim} down -> long-train is "
          f"{cluster.jobs[long_].state.name} "
          f"(reason={cluster.jobs[long_].reason!r})")
    cluster.set_node_state(victim, NodeState.IDLE)
    print(f"node restored -> long-train is "
          f"{cluster.jobs[long_].state.name}\n")

    print("== HA failover (§4 slurm_enable_ha) ==")
    snap = cluster.snapshot()
    standby = Cluster.restore(snap)
    standby.run()
    done = sum(1 for j in standby.jobs.values()
               if j.state == JobState.COMPLETED)
    print(f"standby controller drained the queue: {done}/"
          f"{len(standby.jobs)} completed\n")

    print("== sacct (accounting, §6.1) ==")
    print(commands.sacct(standby))


if __name__ == "__main__":
    main()
