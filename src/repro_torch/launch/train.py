"""`python -m repro_torch.launch.train` — the paper's §5.2.4 job-script
payload, on the CUDA cards (or the CPU with ``--device cpu``).

Trains a (reduced or full) architecture on the synthetic LM pipeline
through the CUDA kernels (``RunConfig(use_kernels=True)``), with
layer-group recomputation and gradient accumulation over
``--microbatches``, on a ``--data`` x ``--model`` mesh under
``--strategy`` and ``--zero`` (the JAX CLI's flags and defaults:
``fsdp_tp``, ZeRO 3).  A mesh of more than one cell runs one process a
cell (``launch.mesh.launch_ranks``): ``--devices`` names the cells'
devices (default ``cuda:0`` .. ``cuda:n-1``, the cards repeated in turn
when there are fewer), ``--backend`` the process groups' (default NCCL
when every cell has a card of its own, gloo when cells share one).
Rank 0's lines are printed.  With ``--ckpt-dir`` a requeued job
resumes from the newest checkpoint there.
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import (
    ARCH_IDS, INPUT_SHAPES, default_opt_state_dtype, get_config,
    get_reduced_config, shape_for,
)
from repro_torch.configs.base import InputShape, RunConfig
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import default_backend, launch_ranks, make_mesh
from repro_torch.monitoring import MetricsRegistry
from repro_torch.optim import OptimizerConfig
from repro_torch.training import Trainer, TrainerConfig


def _parser() -> argparse.ArgumentParser:
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
    ap.add_argument("--data", type=int, default=1, help="data mesh axis")
    ap.add_argument("--model", type=int, default=1, help="model mesh axis")
    ap.add_argument("--strategy", default="fsdp_tp",
                    choices=["dp", "tp", "fsdp", "fsdp_tp"])
    ap.add_argument("--zero", type=int, default=3, choices=[1, 2, 3])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="torch device of every cell (default: cuda; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--devices", default="",
                    help="comma-separated devices, one a cell, row-major "
                         "(default: cuda:0..n-1, repeated when fewer)")
    ap.add_argument("--backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend of a multi-cell mesh")
    return ap


def _setup(args):
    """(cfg, shape, run, opt, tcfg) of the parsed arguments."""
    cfg = (get_reduced_config(args.arch) if args.reduced
           else get_config(args.arch))
    base = INPUT_SHAPES[args.shape]
    shape = InputShape(
        base.name,
        args.seq_len or (256 if args.reduced else base.seq_len),
        args.batch or (8 if args.reduced else base.global_batch),
        base.kind)
    cfg = shape_for(cfg, shape)
    run = RunConfig(strategy=args.strategy, zero_stage=args.zero,
                    use_kernels=True, remat="layer",
                    microbatches=args.microbatches,
                    opt_state_dtype=default_opt_state_dtype(cfg))
    opt = OptimizerConfig(peak_lr=args.lr,
                          warmup_steps=max(args.steps // 10, 1),
                          decay_steps=args.steps,
                          state_dtype=run.opt_state_dtype)
    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir or None,
                         ckpt_every=args.ckpt_every)
    return cfg, shape, run, opt, tcfg


def cell_devices(args, n: int) -> list:
    """The devices of the mesh's cells, row-major."""
    if args.devices:
        devices = [torch.device(d) for d in args.devices.split(",")]
        if len(devices) != n:
            raise SystemExit(f"--devices names {len(devices)} devices for "
                             f"{n} cells")
        return devices
    if args.device is not None:
        return [torch.device(args.device)] * n
    resolve_device("cuda")                 # raises without a card
    cards = torch.cuda.device_count()
    return [torch.device("cuda", i % cards) for i in range(n)]


def train_rank(mesh, argv: list) -> dict:
    """One rank of a multi-cell run: train, and return rank 0's lines."""
    args = _parser().parse_args(argv)
    cfg, shape, run, opt, tcfg = _setup(args)
    metrics = MetricsRegistry()
    lines: list = []
    trainer = Trainer(cfg, run, mesh, shape, opt, tcfg, metrics)
    trainer.train(log=lines.append)
    return {"lines": lines, "dashboard": metrics.dashboard(),
            "history": trainer.history}


def main(argv=None) -> int:
    ap = _parser()
    argv = sys.argv[1:] if argv is None else list(argv)
    args = ap.parse_args(argv)
    n = args.data * args.model
    devices = cell_devices(args, n)
    cfg, shape, run, opt, tcfg = _setup(args)
    if shape.kind != "train":
        ap.error("use repro_torch.launch.serve for decode shapes")
    backend = args.backend or (default_backend(devices) if n > 1 else None)
    print(f"training {cfg.name} ({cfg.param_count():,} params) on "
          f"mesh {{'data': {args.data}, 'model': {args.model}}} "
          f"strategy={args.strategy} zero={args.zero}")
    print(f"  devices {', '.join(map(str, devices))}"
          + (f" ({backend})" if backend else "")
          + f"; seq {shape.seq_len} batch {shape.global_batch} in "
          f"{args.microbatches} microbatch(es), {run.opt_state_dtype} "
          "AdamW state")
    if n == 1:
        metrics = MetricsRegistry()
        mesh = make_mesh(1, 1, devices=devices)
        Trainer(cfg, run, mesh, shape, opt, tcfg, metrics).train()
        dashboard = metrics.dashboard()
    else:
        out = launch_ranks(train_rank, args.data, args.model,
                           devices=devices, backend=backend, args=(argv,),
                           threads=1 if devices[0].type == "cpu" else None)
        for line in out[0]["lines"]:
            print(line)
        dashboard = out[0]["dashboard"]
    print("\n== metrics ==")
    print(dashboard)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
