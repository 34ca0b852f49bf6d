"""Serving tensor parallelism: the plan behind a TP ``DecodeEngine`` and
the processes that run it — the port of the JAX package's
``serving/tp.py``.

The plan is the reference's, word for word in its notices:

* **Attention shards along kv-head groups, the MLP along d_ff.**  Each
  shard holds ``H/tp`` query heads, ``K/tp`` kv heads (the flash kernels
  simply see fewer heads) and ``d_ff/tp`` of the FFN, and each layer
  pays exactly one all-reduce at the attention output projection and one
  at the MLP down-projection (``core.actshard.maybe_psum``).  Embedding,
  LM head and norms stay replicated: every shard computes FULL logits,
  so sampling needs no collective.
* **Reductions run in float32.**  The partial contraction at each
  reduction point stays f32 through the all-reduce and is rounded once
  afterwards, so f32 models decode token-for-token as at tp=1; bf16
  models keep ~1-ulp logit noise from the reassociated sum, which can
  flip an argmax whose top-2 logits collide.
* **Divisibility falls back, never crashes.**  A head or ffn count that
  the shard count does not divide leaves that block replicated (its
  reduction point off) with a notice; SSM state and MoE experts
  replicate the same way.

**Processes.**  Where JAX serves TP from one controller through
``shard_map``, the port runs one process per shard (:func:`launch`), each
a ``torch.distributed`` rank with the same ``DecodeEngine`` host logic on
the same requests.  The ranks' host state stays identical because every
input to a host decision is: the logits are full on every rank and equal
after the all-reduce, the samplers are seeded alike, the admission clock
is rank 0's (:class:`LockstepClock`), and each decode call first compares
a hash of its plan across the ranks (:func:`check_lockstep`).

The paged KV pool shards with attention: each rank holds the ``K/tp``
heads of every page, page *ids* stay one host-side space (one logical
page = one id = ``tp`` rank-local slices), so the allocator, the prefix
cache's refcounts and COW forks are untouched host logic; admission sees
the pool through ``models.paging.ShardedAllocatorView``.
"""
from __future__ import annotations

import zlib
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from repro_torch.configs.base import ModelConfig
from repro_torch.core.sharding import serving_param_pspec
from repro_torch.models.model import cache_kv_head_dim
from repro_torch.models.spec import ParamSpec, layer_schedule, model_spec

#: mesh axis serving TP shards over
TP_AXIS = "model"


@dataclass
class TPPlan:
    """Resolved tensor-parallel plan for one engine instance."""
    mesh: object
    tp: int = 1
    axis: str = TP_AXIS
    shard_attn: bool = False
    shard_mlp: bool = False
    #: divisibility/compat fallbacks, human-readable (sdiag, tests)
    notices: list = field(default_factory=list)

    @property
    def active(self) -> bool:
        """True when any block is actually sharded — otherwise the engine
        runs exactly like TP=1."""
        return (self.mesh is not None and self.tp > 1
                and (self.shard_attn or self.shard_mlp))

    def devices(self) -> list:
        if self.mesh is None:
            return []
        return list(self.mesh.devices.flat)

    def psums_per_token(self, cfg: ModelConfig) -> dict:
        """Cross-shard reductions ONE decode step pays, by kind — the
        sdiag "psum count per dispatch" line (a ``decode_n`` chunk of N
        tokens pays N times this)."""
        sched = layer_schedule(cfg)
        attn = sum(1 for mixer, _ in sched if mixer == "attn")
        mlp = sum(1 for _, ffn in sched if ffn == "dense")
        return {"attn_out": attn if self.shard_attn else 0,
                "mlp_out": mlp if self.shard_mlp else 0}

    def describe(self, cfg: ModelConfig) -> str:
        if self.mesh is None or self.tp <= 1:
            return "tp=1 (single shard)"
        parts = []
        if self.shard_attn:
            parts.append(f"attn(heads {cfg.num_heads}->"
                         f"{cfg.num_heads // self.tp}/shard, kv "
                         f"{cfg.num_kv_heads}->"
                         f"{cfg.num_kv_heads // self.tp}/shard)")
        if self.shard_mlp:
            parts.append(f"mlp(ffn {cfg.d_ff}->"
                         f"{cfg.d_ff // self.tp}/shard)")
        if not parts:
            parts.append("replicated (no shardable dims)")
        return f"tp={self.tp} " + ", ".join(parts)


def plan_tp(cfg: ModelConfig, mesh) -> TPPlan:
    """Resolve which blocks shard over the mesh's ``model`` axis.

    A dimension shards only when the axis size divides it; otherwise that
    block replicates, with a notice instead of a crash.  ``mesh`` needs
    only ``shape`` (axis -> size) and ``axis_names``."""
    if mesh is None:
        return TPPlan(mesh=None)
    tp = int(mesh.shape[TP_AXIS]) if TP_AXIS in mesh.axis_names else 1
    plan = TPPlan(mesh=mesh, tp=tp)
    if tp <= 1:
        return plan
    if cfg.ssm is not None:
        plan.notices.append(
            f"cfg.ssm set: SSM state is not head-sharded yet — "
            f"attention/SSM blocks replicate across tp={tp}")
    elif cfg.num_kv_heads % tp or cfg.num_heads % tp:
        plan.notices.append(
            f"kv_heads={cfg.num_kv_heads}, heads={cfg.num_heads} not "
            f"divisible by tp={tp}: attention replicates (GQA KV-head "
            f"groups must split evenly across shards)")
    else:
        plan.shard_attn = True
    if cfg.moe is not None:
        plan.notices.append(
            f"cfg.moe set: experts are not sharded by serving TP yet — "
            f"MoE blocks replicate across tp={tp}")
    elif cfg.d_ff % tp:
        plan.notices.append(
            f"d_ff={cfg.d_ff} not divisible by tp={tp}: MLP replicates")
    else:
        plan.shard_mlp = True
    if not (plan.shard_attn or plan.shard_mlp):
        plan.notices.append(
            f"nothing shardable: running replicated on 1 of {tp} shards")
    return plan


# ----------------------------------------------------- sharded dimensions ----

def _shard_axes(plan: TPPlan) -> tuple:
    axes = ()
    if plan.shard_attn:
        axes += ("heads", "kv_heads")
    if plan.shard_mlp:
        axes += ("ffn",)
    return axes


def param_pspecs(cfg: ModelConfig, plan: TPPlan):
    """The tree of the parameter tree's sharded dimensions: per leaf the
    dimension split over the shards, or None (replicated)."""
    axes = _shard_axes(plan)

    def build(tree):
        if isinstance(tree, ParamSpec):
            return serving_param_pspec(tree, plan.tp, axes)
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        raise TypeError(type(tree))

    return build(model_spec(cfg))


def cache_pspec(plan: TPPlan, cfg: Optional[ModelConfig] = None):
    """The sharded dimension of every attention KV-cache leaf (the
    ``kv_heads`` axis, :func:`repro_torch.models.model.cache_kv_head_dim`),
    or None when attention replicates."""
    if not plan.shard_attn:
        return None
    return 3 if cfg is None else cache_kv_head_dim(cfg)


def shard_params(params, cfg: ModelConfig, plan: TPPlan, rank: int):
    """Shard ``rank``'s slice of the full parameter tree: each sharded
    leaf's ``rank``-th slice along its dimension as a contiguous copy of
    its own (so the caller can free the full tensors), every replicated
    leaf as it is.  An inactive plan returns ``params``."""
    if not plan.active:
        return params
    dims = param_pspecs(cfg, plan)

    def walk(p, d):
        if isinstance(p, dict):
            return {k: walk(v, d[k]) for k, v in p.items()}
        if isinstance(p, (list, tuple)):
            return [walk(v, dd) for v, dd in zip(p, d)]
        if d is None:
            return p
        n = p.shape[d] // plan.tp
        part = p.narrow(d, rank * n, n)
        return torch.empty(part.shape, dtype=p.dtype,
                           device=p.device).copy_(part)

    return walk(params, dims)


# --------------------------------------------------------------- lockstep ----

class LockstepClock:
    """A clock that reads the same on every rank: rank ``src``'s reading
    of ``source``, broadcast over ``group`` at each :meth:`tick` and frozen
    in between.  Two ranks reading their own clocks could order a
    fair-share near-tie differently, and their host states would part."""

    def __init__(self, source, group, src: int):
        self.source = source
        self.group = group
        self.src = src
        self.now: Optional[float] = None

    def tick(self) -> float:
        mine = float(self.source()) if dist.get_rank() == self.src else 0.0
        t = torch.tensor([mine], dtype=torch.float64)
        dist.broadcast(t, src=self.src, group=self.group)
        self.now = float(t[0])
        return self.now

    def __call__(self) -> float:
        return self.tick() if self.now is None else self.now


def check_lockstep(group, what: str, plan) -> None:
    """Raise unless every rank of ``group`` holds the same ``plan`` (any
    value with a deterministic ``repr``), compared by a hash of it."""
    mine = torch.tensor([zlib.crc32(repr(plan).encode())], dtype=torch.int64)
    seen = [torch.zeros_like(mine)
            for _ in range(dist.get_world_size(group))]
    dist.all_gather(seen, mine, group=group)
    if any(int(t) != int(mine) for t in seen):
        raise RuntimeError(
            f"tensor-parallel ranks diverged at {what}: plan hashes "
            f"{[int(t) for t in seen]} (rank {dist.get_rank()}: {plan!r})")


# -------------------------------------------------------------- processes ----

def launch(fn, tp: int, *, devices, backend: str, args=(),
           threads: Optional[int] = None,
           timeout: Optional[float] = None) -> list:
    """Run ``fn(mesh, *args)`` on ``tp`` ranks of a ``(1, tp)`` mesh and
    return every rank's result, rank 0's first
    (``launch.mesh.launch_ranks``: one ``spawn``ed process a rank, rank r
    on ``devices[r]``; a rank that fails fails the launch)."""
    from repro_torch.launch.mesh import launch_ranks

    return launch_ranks(fn, 1, tp, devices=devices, backend=backend,
                        args=args, threads=threads, timeout=timeout)
