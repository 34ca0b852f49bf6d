"""Scenarios of ``tests/test_torch_dryrun.py`` and the function its gloo
ranks run: one step of each scenario on real CPU tensors, its collectives
counted by ``chip_smoke.py``'s ``timed_collectives``, for the dry run's
census on ``meta`` to be held to.

This module imports no JAX: each rank is a process of its own
(``repro_torch.launch.mesh.launch_ranks``, ``spawn``), which imports it by
name.
"""
from __future__ import annotations

import dataclasses
import sys

import torch

#: (batch, seq) of every scenario (a decode step: slots, cache lines)
SHAPE = (4, 64)
#: a decode step's position: past the first rank's half of the lines
POS = SHAPE[1] // 2 + 8
#: (label, arch, mesh shape, strategy, ZeRO stage, kind, microbatches,
#: config changes)
SCENARIOS = (
    ("stablelm-3b fsdp_tp z3 2x2", "stablelm-3b", (2, 2), "fsdp_tp", 3,
     "train", 2),
    ("stablelm-3b tp 1x2", "stablelm-3b", (1, 2), "tp", 3, "train", 1),
    ("stablelm-3b fsdp z3 2x1", "stablelm-3b", (2, 1), "fsdp", 3, "train",
     1),
    ("stablelm-3b dp z1 2x1", "stablelm-3b", (2, 1), "dp", 1, "train", 1),
    ("stablelm-3b dp z2 2x1", "stablelm-3b", (2, 1), "dp", 2, "train", 2),
    ("mamba2-780m tp 1x2", "mamba2-780m", (1, 2), "tp", 3, "train", 1),
    ("qwen2-moe-a2.7b tp 1x2", "qwen2-moe-a2.7b", (1, 2), "tp", 3, "train",
     1),
    ("qwen2-moe-a2.7b fsdp z3 2x1", "qwen2-moe-a2.7b", (2, 1), "fsdp", 3,
     "train", 1),
    ("stablelm-3b decode tp 1x2", "stablelm-3b", (1, 2), "tp", 3, "decode",
     1),
    # one kv head over 2 ranks: the cache's lines shard over them, under
    # sharded query heads, replicated ones (3 heads) and a 16-line ring
    ("gqa decode tp 1x2", "stablelm-3b", (1, 2), "tp", 3, "decode", 1,
     {"num_kv_heads": 1, "dtype": "float32"}),
    ("gqa 3 heads decode tp 1x2", "stablelm-3b", (1, 2), "tp", 3, "decode",
     1, {"num_heads": 3, "num_kv_heads": 1, "dtype": "float32"}),
    ("gqa window decode tp 1x2", "stablelm-3b", (1, 2), "tp", 3, "decode",
     1, {"num_kv_heads": 1, "sliding_window": 16, "dtype": "float32"}),
    # SSD blocks on a rank's heads: prefill, and decode after it
    ("mamba2-780m prefill tp 1x2", "mamba2-780m", (1, 2), "tp", 3,
     "prefill", 1, {"dtype": "float32"}),
    ("mamba2-780m decode tp 1x2", "mamba2-780m", (1, 2), "tp", 3, "decode",
     1, {"dtype": "float32"}),
)


def scenario(spec):
    """(cfg, RunConfig, InputShape) of a scenario, at reduced size."""
    from repro_torch.configs import InputShape, RunConfig, get_reduced_config

    label, arch, _, strategy, zero, kind, micro = spec[:7]
    run = RunConfig(strategy=strategy, zero_stage=zero, remat="layer",
                    microbatches=micro)
    B, S = SHAPE
    cfg = dataclasses.replace(get_reduced_config(arch),
                              **(spec[7] if len(spec) > 7 else {}))
    return cfg, run, InputShape(label, S, B, kind)


def step_and_args(cfg, run, shape, mesh):
    """The scenario's step on ``mesh`` and its arguments on the mesh's
    device: the rank's shards of seed-0 weights, zero optimizer state or
    cache, a global batch (train), its tokens (prefill) or a token a slot
    (decode)."""
    from repro_torch.models import init_params, make_batch
    from repro_torch.optim import OptimizerConfig
    from repro_torch.serving import make_serve_step
    from repro_torch.serving.serve_step import make_prefill_step
    from repro_torch.training import make_train_step
    from repro_torch.training.train_step import init_opt_state_sharded
    from repro_torch.tree import tree_map

    dev = mesh.device
    if shape.kind == "train":
        step = make_train_step(cfg, run, mesh, OptimizerConfig())
        params = step.layout.shard(init_params(cfg, 0, dev))
        opt = init_opt_state_sharded(params, OptimizerConfig(), step.layout)
        return step, (params, opt, make_batch(cfg, shape, device=dev))
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "prefill":
        step = make_prefill_step(cfg, run, mesh, B, S)
        params = step.layout.layout.shard(init_params(cfg, 0, dev))
        rows = make_batch(cfg, shape, device=dev)
        return step, (params, {"tokens": rows["tokens"]})
    step = make_serve_step(cfg, run, mesh, B, S)
    lay = step.layout
    params = lay.layout.shard(init_params(cfg, 0, dev))
    cache = tree_map(lambda t: torch.zeros(t.shape, dtype=t.dtype,
                                           device=dev), lay.cache())
    token = torch.ones((B, 1), dtype=torch.int32, device=dev)
    return step, (params, cache, token, torch.tensor(POS, device=dev))


def rank_main(mesh, specs, root: str) -> list:
    """One rank: each scenario of ``specs`` on its mesh shape (made from
    this rank's world), one step, its collectives counted as
    ``chip_smoke.py``'s phase 13 counts them (and a decode step's
    logits)."""
    sys.path.insert(0, root)
    import chip_smoke
    from repro_torch.launch.mesh import make_mesh

    world = mesh.devices.size
    out = []
    for spec in specs:
        cfg, run, shape = scenario(spec)
        m = make_mesh(*spec[2], devices=["cpu"] * world, backend="gloo")
        step, args = step_and_args(cfg, run, shape, m)
        stats = dict(s=0.0, bytes=0,
                     **{name: 0 for name in chip_smoke._COLLECTIVES})
        with chip_smoke.timed_collectives(stats, "cpu"):
            result = step(*args)
        out.append({"label": spec[0], "bytes": stats["bytes"],
                    "calls": {n: stats[n] for n in chip_smoke._COLLECTIVES
                              if stats[n]}})
        if shape.kind != "train":
            # the logits and the rank's block of the cache it wrote
            cache = result[1] if shape.kind == "prefill" else args[1]
            out[-1]["logits"] = result[0].float().numpy()
            out[-1]["cache"] = [t.float().numpy() for t in _leaves(cache)]
    return out


def _leaves(tree) -> list:
    from repro_torch.tree import leaves
    return leaves(tree)
