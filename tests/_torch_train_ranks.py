"""Scenarios of ``tests/test_torch_train_parallel.py`` and the function its
training ranks run.

This module imports no JAX: each rank is a process of its own
(``repro_torch.launch.mesh.launch_ranks``, ``spawn``), which imports it by
name.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

#: (batch, seq) of the train-step scenarios, and their optimizer
SHAPE = (4, 32)
OPT = dict(peak_lr=1e-3, warmup_steps=2, decay_steps=50)
STEPS = 2

#: the strategy x ZeRO stage scenarios on reduced stablelm-3b, f32, two
#: microbatches: (label, mesh shape, strategy, zero stage, extra RunConfig)
GRID = tuple(
    (f"{s} z{z} 2x2", (2, 2), s, z, {})
    for s in ("dp", "tp", "fsdp", "fsdp_tp") for z in (1, 2, 3))
TWO = (("dp z1 2x1", (2, 1), "dp", 1, {}),
       ("dp z2 2x1", (2, 1), "dp", 2, {}),
       ("fsdp z3 2x1", (2, 1), "fsdp", 3, {}),
       ("tp z1 1x2", (1, 2), "tp", 1, {}),
       ("fsdp_tp z3 1x2", (1, 2), "fsdp_tp", 3, {}))
#: the knobs, each against the JAX one-device step with the same knob
KNOBS = (("gather_bf16 2x2", (2, 2), "fsdp_tp", 3, {"gather_bf16": True}),
         ("grad_reduce_bf16 2x2", (2, 2), "fsdp_tp", 3,
          {"grad_reduce_bf16": True}),
         ("grad_reduce_bf16 4x1", (4, 1), "fsdp", 2,
          {"grad_reduce_bf16": True}))
#: other configs: (label, arch, mesh shape, strategy, zero, microbatches,
#: (batch, seq))
OTHERS = (("starcoder2 gqa tp 1x4", "starcoder2-3b", (1, 4), "tp", 1, 2,
           SHAPE),
          ("starcoder2 gqa fsdp_tp 2x2", "starcoder2-3b", (2, 2), "fsdp_tp",
           3, 2, SHAPE),
          ("mamba2 fsdp z3 2x1", "mamba2-780m", (2, 1), "fsdp", 3, 2,
           SHAPE),
          ("qwen2-moe dp 2x1", "qwen2-moe-a2.7b", (2, 1), "dp", 1, 1,
           (4, 64)),
          ("qwen2-moe fsdp z3 2x1", "qwen2-moe-a2.7b", (2, 1), "fsdp", 3,
           1, (4, 64)))


def f32_reduced(arch: str):
    from repro_torch.configs import get_reduced_config
    return dataclasses.replace(get_reduced_config(arch), dtype="float32")


def batches(cfg, shape, steps=STEPS, seed=0) -> list:
    """``steps`` global batches of token ids, labels and a loss mask whose
    rows differ in their count of masked tokens (numpy)."""
    rng = np.random.default_rng(seed)
    B, S = shape
    out = []
    for _ in range(steps):
        out.append({
            "tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(
                np.int32),
            "loss_mask": (rng.random((B, S)) > 0.1 + 0.2 * np.arange(
                B)[:, None] / B).astype(np.float32)})
    return out


def _meshes(world: int):
    """Every (data, model) mesh of ``world`` cells this launch uses, made
    in the same order on every rank (group creation is collective)."""
    from repro_torch.launch.mesh import make_mesh
    shapes = [(world, 1), (1, world)] + ([(2, 2)] if world == 4 else [])
    return {s: make_mesh(*s, devices=["cpu"] * world, backend="gloo")
            for s in shapes}


def _train(cfg, mesh, run, params_np, batch_list, opt=OPT):
    """``STEPS`` steps of the train step from whole numpy weights (AdamW
    with ``opt``); rank 0 returns the metrics of every step and the whole
    final parameters."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training.train_step import (
        init_opt_state_sharded, make_train_step,
    )
    from repro_torch.tree import leaves
    from repro_torch.weights import params_from_jax

    opt = OptimizerConfig(**opt)
    step = make_train_step(cfg, run, mesh, opt)
    lay = step.layout
    params = lay.shard(params_from_jax(params_np), "param")
    state = init_opt_state_sharded(params, opt, lay)
    metrics = []
    for b in batch_list:
        params, state, m = step(params, state, {
            k: torch.from_numpy(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in m.items()})
    whole = [t.numpy().copy() for t in leaves(lay.gather_tree(params))]
    return {"metrics": metrics,
            "params": whole if mesh.rank == 0 else None}


def _pipeline(mesh):
    """Two stages x 4 microbatches (the JAX test's sizes): outputs and the
    gradient of ``sum(y ** 2)`` on every stage, the gradient summed over
    the stages."""
    import torch.distributed as dist
    from repro_torch.core.pipeline import make_pipeline_mesh, pipeline_apply

    w, x = pipeline_inputs()
    pm = make_pipeline_mesh(2)
    w = w.requires_grad_(True)
    y = pipeline_apply(stage_fn, w, x, pm)
    (g,) = torch.autograd.grad(torch.sum(y ** 2), [w])
    dist.all_reduce(g, group=pm.group)
    return {"y": y.detach().numpy(), "grad": g.numpy()}


def pipeline_inputs():
    rng = np.random.default_rng(0)
    L, d, n_micro = 4, 16, 4
    w = torch.from_numpy(
        (rng.standard_normal((L, d, d)) * 0.3).astype(np.float32))
    x = torch.from_numpy(
        rng.standard_normal((n_micro, 2, d)).astype(np.float32))
    return w, x


def stage_fn(params, h):
    for i in range(params.shape[0]):
        h = torch.tanh(h @ params[i])
    return h


def _checkpoint(mesh, cfg, params_np, ckpt_dir):
    """A ``Trainer`` on the 2x2 mesh under fsdp_tp ZeRO 3 from the given
    weights, 2 steps, a checkpoint at step 2; then a second one asked for
    3 steps, which resumes there from its shards of the whole leaves.
    Returns both trainers' losses.  The saves gather slices of 1,024
    elements, so every leaf but the smallest is written in several."""
    from repro_torch.configs import InputShape, RunConfig
    from repro_torch.core import zero
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training import Trainer, TrainerConfig
    from repro_torch.weights import params_from_jax

    t = Trainer(cfg, RunConfig(use_kernels=True, microbatches=2), mesh,
                InputShape("t", SHAPE[1], SHAPE[0], "train"),
                OptimizerConfig(**OPT),
                TrainerConfig(steps=2, log_every=100, ckpt_every=2,
                              ckpt_dir=ckpt_dir))
    t.params = t.layout.shard(params_from_jax(params_np), "param")
    zero.SLICE_ELEMS = 1 << 10
    first = [h["loss"] for h in t.train(log=lambda *_: None)]
    t = Trainer(cfg, RunConfig(use_kernels=True, microbatches=2), mesh,
                InputShape("t", SHAPE[1], SHAPE[0], "train"),
                OptimizerConfig(**OPT),
                TrainerConfig(steps=3, log_every=100, ckpt_dir=ckpt_dir))
    return first, [(h["step"], h["loss"])
                   for h in t.train(log=lambda *_: None)]


def resume_trainer(cfg, mesh, strategy: str, zero: int, steps: int,
                   ckpt_dir: str, device=None):
    """The resume scenario's ``Trainer``: f32, two microbatches of
    ``SHAPE``, AdamW with ``OPT``, checkpoints in ``ckpt_dir``."""
    from repro_torch.configs import InputShape, RunConfig
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training import Trainer, TrainerConfig

    return Trainer(cfg, RunConfig(strategy=strategy, zero_stage=zero,
                                  use_kernels=True, microbatches=2), mesh,
                   InputShape("t", SHAPE[1], SHAPE[0], "train"),
                   OptimizerConfig(**OPT),
                   TrainerConfig(steps=steps, log_every=100,
                                 ckpt_dir=ckpt_dir), device=device)


def _resume(meshes, cfg, params_np, ckpt_dir):
    """Reduced mamba2-780m under dp ZeRO 2 on the 2x1 mesh from the given
    weights: a step, a checkpoint (its optimizer state gathered from the
    ranks' slices), a second step; then a trainer under tp on 1x2 (the
    SSD heads split) resumes from the checkpoint and takes step 2.
    Returns the metrics of both runs' steps."""
    from repro_torch.weights import params_from_jax

    t = resume_trainer(cfg, meshes[(2, 1)], "dp", 2, 1, ckpt_dir)
    t.params = t.layout.shard(params_from_jax(params_np), "param")
    t.train(log=lambda *_: None)
    t.save()
    t.tcfg.steps = 2
    t.train(log=lambda *_: None)
    r = resume_trainer(cfg, meshes[(1, 2)], "tp", 3, 2, ckpt_dir)
    r.train(log=lambda *_: None)
    return {"uninterrupted": t.history, "tp": r.history}


def rank_main(mesh, jobs: dict) -> dict:
    """Every scenario of one launch, in the same order on every rank.
    ``jobs``: "weights" (arch -> whole numpy params), "train" (a list of
    (label, arch, mesh shape, RunConfig kwargs, (batch, seq))),
    "pipeline", "checkpoint" (a directory), "resume" (a directory; 2
    ranks), "cli" (the train CLI's argv)."""
    from repro_torch.configs import RunConfig

    torch.manual_seed(0)
    world = mesh.devices.size
    meshes = _meshes(world)
    out = {"train": {}}
    for label, arch, shape, run_kw, bshape in jobs.get("train", ()):
        cfg = f32_reduced(arch)
        run = RunConfig(use_kernels=True, remat="layer", **run_kw)
        out["train"][label] = _train(cfg, meshes[shape], run,
                                     jobs["weights"][arch],
                                     batches(cfg, bshape))
    if jobs.get("pipeline"):
        out["pipeline"] = _pipeline(mesh)
    if jobs.get("checkpoint"):
        out["checkpoint"] = _checkpoint(
            meshes[(2, 2)], f32_reduced("stablelm-3b"),
            jobs["weights"]["stablelm-3b"], jobs["checkpoint"])
    if jobs.get("resume"):
        out["resume"] = _resume(meshes, f32_reduced("mamba2-780m"),
                                jobs["weights"]["mamba2-780m"],
                                jobs["resume"])
    if jobs.get("cli"):
        from repro_torch.launch.train import train_rank
        out["cli"] = train_rank(meshes[(2, 2)], jobs["cli"])["lines"]
    return out
