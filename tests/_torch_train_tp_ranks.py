"""Scenarios of ``tests/test_torch_train_tp_families.py`` and the function
its training ranks run.

This module imports no JAX: each rank is a process of its own
(``repro_torch.launch.mesh.launch_ranks``, ``spawn``), which imports it by
name.
"""
from __future__ import annotations

import dataclasses

import torch

import _torch_train_ranks as R
from _torch_train_ranks import SHAPE, batches, f32_reduced

#: ``_torch_train_ranks.OPT`` with AdamW's eps at 1e-6.  At 1e-8 an
#: element whose first gradient lies near eps moves by ``lr * g / (|g| +
#: eps)``, which turns a summation-order difference of a few 1e-9 into
#: 1e-4 of a parameter: one element of reduced qwen2-moe's shared ``w3``
#: (a first gradient of 1.0e-8 on one device, 1.5e-8 over 2 ranks) and
#: one of stablelm-3b's embedding did so against JAX.  At 1e-6 the same
#: difference moves a parameter by ~1e-7, and a wrong gradient of 1e-6 or
#: more still moves it by a share of ``lr``.
OPT = dict(R.OPT, eps=1e-6)

#: (batch, seq) of the MoE and hybrid scenarios: whole token groups (64
#: tokens) on each data rank of a (2, 2) mesh.  Every scenario takes one
#: microbatch (``test_torch_train_parallel.py`` holds two).
MOE_SHAPE = (4, 64)

#: the scenarios: (label, arch, variant, (data, model), RunConfig kwargs).
#: The variants (:func:`variant`) cut a reduced config where the model
#: axis divides less: 3 routed experts (TP-in-expert); 3 query heads and
#: a vocabulary of 511 (attention, embedding and head replicated); 15 SSD
#: heads over an inner dim of 480.
CASES = (
    ("mamba2 tp 1x2", "mamba2-780m", None, (1, 2),
     dict(strategy="tp", zero_stage=1)),
    ("mamba2 fsdp_tp z3 2x2", "mamba2-780m", None, (2, 2),
     dict(strategy="fsdp_tp", zero_stage=3)),
    ("jamba tp 1x2", "jamba-1.5-large-398b", None, (1, 2),
     dict(strategy="tp", zero_stage=1)),
    ("jamba fsdp_tp z3 2x2", "jamba-1.5-large-398b", None, (2, 2),
     dict(strategy="fsdp_tp", zero_stage=3)),
    ("qwen2-moe tp 1x2", "qwen2-moe-a2.7b", None, (1, 2),
     dict(strategy="tp", zero_stage=1)),
    ("qwen2-moe fsdp_tp z3 2x2", "qwen2-moe-a2.7b", None, (2, 2),
     dict(strategy="fsdp_tp", zero_stage=3)),
    ("qwen2-moe 3 experts tp 1x2", "qwen2-moe-a2.7b", "experts3", (1, 2),
     dict(strategy="tp", zero_stage=1)),
    ("qwen2-moe 3 experts defer_combine tp 1x2", "qwen2-moe-a2.7b",
     "experts3", (1, 2),
     dict(strategy="tp", zero_stage=1, moe_defer_combine=True)),
    ("stablelm seq_parallel tp 1x2", "stablelm-3b", None, (1, 2),
     dict(strategy="tp", zero_stage=1, seq_parallel=True)),
    ("stablelm 3 heads vocab 511 seq_parallel tp 1x2", "stablelm-3b",
     "heads3", (1, 2), dict(strategy="tp", zero_stage=1, seq_parallel=True)),
    ("mamba2 seq_parallel tp 1x2", "mamba2-780m", None, (1, 2),
     dict(strategy="tp", zero_stage=1, seq_parallel=True)),
    ("mamba2 15 heads tp 1x2", "mamba2-780m", "heads15", (1, 2),
     dict(strategy="tp", zero_stage=1)),
    ("mamba2 15 heads seq_parallel tp 1x2", "mamba2-780m", "heads15",
     (1, 2), dict(strategy="tp", zero_stage=1, seq_parallel=True)),
    ("jamba seq_parallel tp 1x2", "jamba-1.5-large-398b", None, (1, 2),
     dict(strategy="tp", zero_stage=1, seq_parallel=True)),
    ("qwen2-moe 3 experts seq_parallel tp 1x2", "qwen2-moe-a2.7b",
     "experts3", (1, 2),
     dict(strategy="tp", zero_stage=1, seq_parallel=True)),
    # the knobs change no layout outside a TP strategy
    ("stablelm dp seq_parallel 1x2", "stablelm-3b", None, (1, 2),
     dict(strategy="dp", zero_stage=1, seq_parallel=True)),
    ("stablelm fsdp moe_defer_combine 1x2", "stablelm-3b", None, (1, 2),
     dict(strategy="fsdp", zero_stage=3, moe_defer_combine=True)),
)

#: scenarios whose router gradient is also taken on its own, at the
#: initial weights on the first batch
ROUTER = ("qwen2-moe tp 1x2", "qwen2-moe 3 experts tp 1x2",
          "qwen2-moe 3 experts defer_combine tp 1x2",
          "qwen2-moe 3 experts seq_parallel tp 1x2")


def variant(cfg, name):
    """A reduced config (the JAX package's or the port's) cut as
    :data:`CASES` names it."""
    if name is None:
        return cfg
    if name == "experts3":
        return dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, num_experts=3))
    if name == "heads3":
        return dataclasses.replace(cfg, num_heads=3, num_kv_heads=3,
                                   vocab_size=511)
    if name == "heads15":
        return dataclasses.replace(cfg, d_model=240)
    raise ValueError(name)


def shape_of(arch):
    """(batch, seq) of an arch's scenarios."""
    if arch in ("qwen2-moe-a2.7b", "jamba-1.5-large-398b"):
        return MOE_SHAPE
    return SHAPE


def _router_grads(cfg, mesh, run, params_np, batch):
    """The router leaves' gradients (reduced as the step reduces them) of
    one batch at the given weights: whole numpy arrays, in leaf order."""
    from repro_torch.optim import OptimizerConfig
    from repro_torch.training.train_step import make_train_step
    from repro_torch.tree import leaves_with_path
    from repro_torch.weights import params_from_jax

    step = make_train_step(cfg, run, mesh, OptimizerConfig())
    lay = step.layout
    params = lay.shard(params_from_jax(params_np), "param")
    grads, _ = step.grads(params, {k: torch.from_numpy(v)
                                   for k, v in batch.items()})
    paths = [p for p, _ in leaves_with_path(params)]
    return [g.numpy().copy() for p, g in zip(paths, grads)
            if "'router'" in p]


def rank_main(mesh, jobs: dict) -> dict:
    """Every scenario of ``jobs["cases"]`` (labels of :data:`CASES` whose
    mesh this launch holds) from the whole numpy weights
    ``jobs["weights"]`` ((arch, variant) -> params), in the same order on
    every rank; rank 0 returns each run's metrics and final parameters
    and, for :data:`ROUTER`, the router gradients."""
    from repro_torch.configs import RunConfig
    from repro_torch.launch.mesh import make_mesh

    torch.manual_seed(0)
    world = mesh.devices.size
    shapes = [(1, 2)] if world == 2 else [(2, 2)]
    meshes = {s: make_mesh(*s, devices=["cpu"] * world, backend="gloo")
              for s in shapes}
    out = {"train": {}, "router": {}}
    for label, arch, var, shape, kw in CASES:
        if label not in jobs["cases"]:
            continue
        cfg = variant(f32_reduced(arch), var)
        bshape = shape_of(arch)
        run = RunConfig(use_kernels=True, remat="layer", **kw)
        weights = jobs["weights"][(arch, var)]
        data = batches(cfg, bshape)
        out["train"][label] = R._train(cfg, meshes[shape], run, weights,
                                       data, opt=OPT)
        if label in ROUTER:
            out["router"][label] = _router_grads(cfg, meshes[shape], run,
                                                 weights, data[0])
    return out
