"""Quickstart: the guide's end-to-end loop in one minute.

The port's twin of ``examples/quickstart.py``.  Provision a
software-defined cluster (the §4 DeepOps flow; the JAX example's 4 x 4
host inventory, so that ``sinfo`` and ``sacct`` print the same tables),
validate it (§4 step 8), submit a real training job with ``sbatch``
(§5.2.3), watch it with ``squeue``/``sinfo``, and read the accounting
with ``sacct`` (§6).

The job's 64-chip allocation folds onto the one device named here
(``cluster.meshbridge.mesh_for_job``), as the JAX example's folds onto the
CPU devices, and its ``Trainer`` runs in this process on it.

Run on the card:  PYTHONPATH=src python examples/torch/quickstart.py
Run on the CPU:   PYTHONPATH=src python examples/torch/quickstart.py \\
                      --device cpu [--steps 4]
"""
import argparse

from repro_torch.cluster import commands, provision, tpu_pod_spec, validate
from repro_torch.cluster.meshbridge import mesh_for_job
from repro_torch.configs import RunConfig, get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.device import resolve_device
from repro_torch.monitoring import MetricsRegistry
from repro_torch.optim import OptimizerConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=20)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    # ---- provision + validate (paper §4) --------------------------------
    spec = tpu_pod_spec(name="v5e-demo", hosts_x=4, hosts_y=4)   # 64 chips
    cluster = provision(spec, real_mode=True)
    report = validate(cluster, spec)
    print("== slurm-validation ==")
    print(report, "\n")

    print("== sinfo ==")
    print(commands.sinfo(cluster), "\n")

    # ---- the deep_learning_job of §5.2.4 --------------------------------
    metrics = MetricsRegistry()

    def train_script(job, alloc):
        cfg = get_reduced_config("stablelm-3b")
        mesh = mesh_for_job(cluster, job, devices=[device])
        trainer = Trainer(
            cfg, RunConfig(strategy="dp", remat="none"), None,
            InputShape("demo", 64, 4, "train"),
            OptimizerConfig(peak_lr=1e-3, warmup_steps=5, decay_steps=100),
            TrainerConfig(steps=args.steps, log_every=5), metrics=metrics,
            device=mesh.devices.flat[0])
        return trainer.train()

    msg = commands.sbatch(
        cluster, name="deep_learning_job", nodes=4, gres="tpu:4",
        cpus_per_task=8, mem="32G", time="24:00:00", script=train_script)
    print("== sbatch ==")
    print(msg, "\n")

    print("== squeue ==")
    print(commands.squeue(cluster), "\n")

    cluster.run()

    print("\n== sacct ==")
    print(commands.sacct(cluster), "\n")

    print("== metrics (ascii grafana, §6) ==")
    print(metrics.dashboard())

    job = cluster.jobs[int(msg.split()[-1])]
    if job.exit_code != 0:
        raise SystemExit(f"job failed: {job.comment}")


if __name__ == "__main__":
    main()
