"""End-to-end driver: train the ~100M ``repro-100m`` model for a few hundred
steps, submitted through the SLURM layer exactly like the guide's §5.2.4
job script — with checkpoints, resume, and Prometheus metrics.

The port's twin of ``examples/train_cluster.py``: ``repro-100m`` at full
size under ``fsdp_tp``, checkpointed every 100 steps into the port's
store (the JAX layout: the JAX ``Trainer`` restores it too).  A job
requeued or run again on the same ``--ckpt-dir`` resumes from its LATEST
checkpoint.  The 64-chip allocation folds onto the one device named here
(``cluster.meshbridge.mesh_for_job``), and the job's ``Trainer`` runs in
this process on it.

Run on the card:  PYTHONPATH=src python examples/torch/train_cluster.py \\
                      [--steps 300] [--ckpt-dir DIR]
Run on the CPU:   PYTHONPATH=src python examples/torch/train_cluster.py \\
                      --device cpu --reduced --steps 100 --batch 2 \\
                      --seq 16 --ckpt-dir DIR
(``--reduced``: the config's reduced widths, for a quick run on the CPU.)
"""
import argparse
import os
import tempfile

from repro_torch.cluster import commands, provision, tpu_pod_spec
from repro_torch.cluster.meshbridge import mesh_for_job
from repro_torch.configs import RunConfig, get_config, get_reduced_config
from repro_torch.configs.base import InputShape
from repro_torch.device import resolve_device
from repro_torch.monitoring import MetricsRegistry
from repro_torch.optim import OptimizerConfig
from repro_torch.training.trainer import Trainer, TrainerConfig


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--reduced", action="store_true",
                    help="repro-100m's reduced widths")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_100m_ckpt"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    cluster = provision(tpu_pod_spec(hosts_x=4, hosts_y=4), real_mode=True)
    metrics = MetricsRegistry()
    cluster.metrics = metrics

    cfg = (get_reduced_config if args.reduced else get_config)("repro-100m")
    print(f"model: {cfg.name}  params={cfg.param_count():,}")

    def train_script(job, alloc):
        mesh = mesh_for_job(cluster, job, devices=[device])
        trainer = Trainer(
            cfg,
            RunConfig(strategy="fsdp_tp", microbatches=1, remat="layer"),
            None,
            InputShape("train", args.seq, args.batch, "train"),
            OptimizerConfig(peak_lr=3e-4, warmup_steps=20,
                            decay_steps=args.steps),
            TrainerConfig(steps=args.steps, log_every=10, ckpt_every=100,
                          ckpt_dir=args.ckpt_dir),
            metrics=metrics, device=mesh.devices.flat[0])
        history = trainer.train()
        return history

    msg = commands.sbatch(cluster, name="train_repro_100m", nodes=16,
                          gres="tpu:4", mem="32G", time="24:00:00",
                          script=train_script, run_time_s=3600)
    print(msg)
    job = cluster.jobs[int(msg.split()[-1])]
    if job.exit_code != 0:
        raise SystemExit(f"job failed: {job.comment}")
    history = job.result
    if not history:
        raise SystemExit(f"nothing to train: {args.ckpt_dir} already holds "
                         f"step {args.steps} or later")
    first, last = history[0], history[-1]
    print(f"\nloss: {first['loss']:.4f} (step {first['step']}) -> "
          f"{last['loss']:.4f} (step {last['step']})")
    cluster.run()
    print(commands.sacct(cluster))


if __name__ == "__main__":
    main()
