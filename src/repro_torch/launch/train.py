"""`python -m repro_torch.launch.train` — the paper's §5.2.4 job-script
payload, on one CUDA card (or the CPU with ``--device cpu``).

Trains a (reduced or full) architecture on the synthetic LM pipeline
through the CUDA kernels (``RunConfig(use_kernels=True)``), with
layer-group recomputation and gradient accumulation over
``--microbatches``.  The mesh flags of the JAX CLI (``--data``,
``--model``, ``--strategy``, ``--zero``) come with the multi-device
slice.  With ``--ckpt-dir`` a requeued job resumes from the newest
checkpoint there.
"""
from __future__ import annotations

import argparse

from repro_torch.configs import (
    ARCH_IDS, INPUT_SHAPES, default_opt_state_dtype, get_config,
    get_reduced_config, shape_for,
)
from repro_torch.configs.base import InputShape, RunConfig
from repro_torch.device import resolve_device
from repro_torch.monitoring import MetricsRegistry
from repro_torch.optim import OptimizerConfig
from repro_torch.training import Trainer, TrainerConfig


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="repro_torch.launch.train")
    ap.add_argument("--arch", default="stablelm-3b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k",
                    choices=list(INPUT_SHAPES))
    ap.add_argument("--reduced", action="store_true",
                    help="reduced config + small batch (CPU smoke)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=0,
                    help="override sequence length")
    ap.add_argument("--batch", type=int, default=0,
                    help="override global batch")
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    base = INPUT_SHAPES[args.shape]
    shape = InputShape(
        base.name,
        args.seq_len or (256 if args.reduced else base.seq_len),
        args.batch or (8 if args.reduced else base.global_batch),
        base.kind)
    if shape.kind != "train":
        ap.error("use repro_torch.launch.serve for decode shapes")
    cfg = shape_for(cfg, shape)
    run = RunConfig(use_kernels=True, remat="layer",
                    microbatches=args.microbatches,
                    opt_state_dtype=default_opt_state_dtype(cfg))
    opt = OptimizerConfig(peak_lr=args.lr,
                          warmup_steps=max(args.steps // 10, 1),
                          decay_steps=args.steps,
                          state_dtype=run.opt_state_dtype)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir or None,
                         ckpt_every=args.ckpt_every)
    metrics = MetricsRegistry()
    print(f"training {cfg.name} ({cfg.param_count():,} params) on {device} "
          f"seq {shape.seq_len} batch {shape.global_batch} in "
          f"{args.microbatches} microbatch(es), {run.opt_state_dtype} "
          "AdamW state")
    trainer = Trainer(cfg, run, shape, opt, tcfg, metrics, device=device)
    trainer.train()
    print("\n== metrics ==")
    print(metrics.dashboard())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
