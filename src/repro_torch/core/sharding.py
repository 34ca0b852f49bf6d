"""Logical-axis -> mesh-axis mapping: sharding specs for parameters,
optimizer state, batches and decode caches — the port of the JAX
package's ``core/sharding.py``.

The port has no ``NamedSharding``.  A sharding here is its spec: a tuple
with one entry per dimension, the entries of JAX's ``PartitionSpec`` —
``None`` (replicated), ``"model"``, ``"data"`` or ``("pod", "data")`` —
read beside the mesh whose ranks hold the leaf (``core.zero`` slices and
gathers by it).  ``mesh`` is anything with ``shape`` (axis -> size) and
``axis_names``: the port's ``launch.mesh.Mesh`` or a stand-in.

The rules are the JAX package's, edge cases included: a dim is sharded
on a mesh axis only if its size divides evenly; otherwise the next
candidate (or replication) is chosen — mirroring what real deployments
do when e.g. GQA kv_heads < TP.

``serving_param_pspec`` is the serving half: the dimension one parameter
shards on under serving tensor parallelism.
"""
from __future__ import annotations

import math
from typing import Optional

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.parallelism import (
    NEVER_SHARD, TP_AXIS_PRIORITY, Strategy, get_strategy,
)
from repro_torch.models.spec import ParamSpec, model_spec


def _axis_size(mesh, name: str) -> int:
    return mesh.shape[name] if name in mesh.axis_names else 1


def batch_partition(mesh, global_batch: int,
                    strategy: Strategy) -> Optional[tuple[str, ...]]:
    """Mesh axes carrying the batch dim (longest divisible prefix-product)."""
    axes = [a for a in strategy.batch_axes if a in mesh.axis_names]
    while axes:
        total = math.prod(_axis_size(mesh, a) for a in axes)
        if global_batch % total == 0:
            return tuple(axes)
        axes.pop(0)          # drop the outermost ("pod") first
    return None


def _entry(axes: Optional[tuple]):
    """A spec entry for a group of mesh axes, normalised as
    ``PartitionSpec`` normalises it: one axis stands alone."""
    if axes is not None and len(axes) == 1:
        return axes[0]
    return axes


def param_pspec(ps: ParamSpec, mesh, strategy: Strategy,
                fsdp_override: Optional[bool] = None) -> tuple:
    """Spec of one parameter from its logical axes."""
    spec: list = [None] * len(ps.shape)
    model_n = _axis_size(mesh, "model")
    fsdp = strategy.fsdp if fsdp_override is None else fsdp_override

    # ---- tensor/expert parallelism on `model`, by priority ----
    if strategy.tp and model_n > 1:
        for logical in TP_AXIS_PRIORITY:
            placed = False
            for i, (ax, n) in enumerate(zip(ps.axes, ps.shape)):
                if ax == logical and n % model_n == 0 and spec[i] is None:
                    spec[i] = "model"
                    placed = True
                    break
            if placed:
                break

    # ---- ZeRO-3 / FSDP storage sharding on the batch axes (largest free
    # dim; ties go to the later dim).  Multi-pod meshes shard over ("pod",
    # "data"). ----
    data_n = _axis_size(mesh, "data")
    pod_n = _axis_size(mesh, "pod") if "pod" in mesh.axis_names else 1
    groups = []
    if pod_n > 1:
        groups.append((("pod", "data"), pod_n * data_n))
    groups.append((("data",), data_n))
    for axes, total in groups:
        if not fsdp or total <= 1:
            continue
        cands = [
            (n, i) for i, (ax, n) in enumerate(zip(ps.axes, ps.shape))
            if spec[i] is None and ax not in NEVER_SHARD
            and n % total == 0 and n >= total
        ]
        if cands:
            _, i = max(cands)
            spec[i] = axes if len(axes) > 1 else axes[0]
            break
    return tuple(spec)


def serving_param_pspec(ps: ParamSpec, tp: int, shard_axes) -> Optional[int]:
    """The dimension of one parameter that shards over ``tp`` serving
    shards, or None (replicated).

    Serving shards ONLY the logical axes in ``shard_axes`` (heads,
    kv_heads and ffn, per the engine's TP plan) and replicates everything
    else, the vocabulary included: every shard samples from full logits.
    The shard lands on the first matching axis whose size ``tp`` divides
    (at most one per parameter), as the JAX rule places the mesh axis."""
    for i, (ax, n) in enumerate(zip(ps.axes, ps.shape)):
        if ax in shard_axes and n % tp == 0:
            return i
    return None


def _spec_tree(cfg: ModelConfig, mesh, strategy: Strategy, fsdp: bool):
    def build(tree):
        if isinstance(tree, ParamSpec):
            return param_pspec(tree, mesh, strategy, fsdp_override=fsdp)
        if isinstance(tree, dict):
            return {k: build(v) for k, v in tree.items()}
        if isinstance(tree, list):
            return [build(v) for v in tree]
        raise TypeError(type(tree))

    return build(model_spec(cfg))


def param_shardings(cfg: ModelConfig, mesh, run: RunConfig):
    """Spec tree matching the parameter tree.

    ZeRO stage semantics (paper §7.2): stage 3 shards parameters themselves;
    stages 1/2 keep parameters data-replicated (TP still applies) and shard
    only optimizer state (and, for 2, gradients) — see ``opt_shardings`` /
    ``core.zero.grad_shardings``.
    """
    strategy = get_strategy(run.strategy)
    return _spec_tree(cfg, mesh, strategy,
                      strategy.fsdp and run.zero_stage >= 3)


def opt_shardings(cfg: ModelConfig, mesh, run: RunConfig):
    """Optimizer-state (m/v) specs: ZeRO>=1 always data-shards them, under
    every strategy."""
    strategy = get_strategy(run.strategy)
    return _spec_tree(cfg, mesh, strategy,
                      (strategy.fsdp and run.zero_stage >= 1)
                      or run.zero_stage >= 1)


def batch_shardings(cfg: ModelConfig, mesh, run: RunConfig,
                    specs: dict) -> dict:
    """Specs of a batch dict (train or decode inputs); ``specs`` maps each
    key to anything with a ``shape``."""
    strategy = get_strategy(run.strategy)
    out = {}
    for k, s in specs.items():
        shape = tuple(getattr(s, "shape", ()))
        if k == "pos" or len(shape) == 0:
            out[k] = ()
            continue
        baxes = _entry(batch_partition(mesh, shape[0], strategy))
        out[k] = (baxes,) + (None,) * (len(shape) - 1)
    return out


def cache_shardings(cfg: ModelConfig, mesh, run: RunConfig,
                    cache_abstract, paging: bool = False):
    """Specs of the decode cache tree.

    batch -> (pod, data) when divisible; kv_heads/ssm_head -> model when
    divisible, else the cache sequence dim -> model (sequence-sharded KV).
    ``paging=True`` matches a paged-pool cache (no batch dim: pages replace
    (batch, seq), so the batch rule never lands on the page axis).
    """
    from repro_torch.models.model import cache_logical_axes
    strategy = get_strategy(run.strategy)
    model_n = _axis_size(mesh, "model")
    axes_tree = cache_logical_axes(cfg, paging=paging)

    def leaf_spec(arr, axes):
        spec: list = [None] * len(arr.shape)
        used_model = False
        for i, ax in enumerate(axes):
            n = arr.shape[i]
            if ax == "batch":
                spec[i] = _entry(batch_partition(mesh, n, strategy))
            elif ax in ("kv_heads", "ssm_head") and strategy.tp and \
                    model_n > 1 and n % model_n == 0:
                spec[i] = "model"
                used_model = True
        if strategy.tp and model_n > 1 and not used_model:
            for i, ax in enumerate(axes):
                if ax == "cache_seq" and arr.shape[i] % model_n == 0:
                    spec[i] = "model"
                    break
        return tuple(spec)

    def walk(arr, axes):
        if isinstance(arr, dict):
            return {k: walk(arr[k], axes[k]) for k in arr}
        if isinstance(arr, (list, tuple)):
            return [walk(a, x) for a, x in zip(arr, axes)]
        return leaf_spec(arr, axes)

    return walk(cache_abstract, axes_tree)


def make_activation_rules(cfg: ModelConfig, mesh, run: RunConfig):
    """Activation-sharding rules (see core/actshard.py) for one run:
    ``rules(name, shape)`` -> spec tuple, or None for a name with no rule.

    Logical names (shapes as produced by the model code):
      hidden       (B, S, D)        batch -> (pod, data)
      heads        (B, S, H, Dh)    + H -> model when divisible
      kv           (B, S, K, Dh)    + K -> model when divisible
      ffn_hidden   (B, S, F)        + F -> model when divisible
      logits       (B, S, V)        + V -> model when divisible
      moe_tokens   (G, gs, D)       G (token groups) -> (pod, data)
      moe_dispatch (G, gs, E, C)    + E -> model when divisible
      moe_expert   (G, E, C, D|F)   + E -> model; else last dim (TP-in-expert)
      ssm_heads    (B, S, H, P)     + H -> model when divisible
      ssm_inner    (B, S, C)        + C -> model when divisible (conv channels)

    Every rule pins dim0 to the batch axes.
    """
    strategy = get_strategy(run.strategy)
    model_n = _axis_size(mesh, "model")
    tp = strategy.tp and model_n > 1

    def mdl(n: int):
        return "model" if (tp and n % model_n == 0 and n >= model_n) else None

    # sequence parallelism (run.seq_parallel): when the head count does
    # NOT divide `model`, shard the sequence dim there instead
    def seq(n: int):
        return "model" if (run.seq_parallel and tp
                           and n % model_n == 0 and n >= model_n) else None

    def rules(name: str, shape: tuple):
        b = _entry(batch_partition(mesh, shape[0], strategy))

        if name == "hidden":
            return (b, seq(shape[1]) if len(shape) == 3 else None, None)
        if name == "heads":
            h = mdl(shape[2])
            s = None if h else seq(shape[1])
            return (b, s, h, None)
        if name == "kv":
            h = mdl(shape[2])
            if run.seq_parallel and mdl(shape[2]) is None:
                h = None
            return (b, None, h, None)
        if name == "ssm_heads":
            return (b, None, mdl(shape[2]), None)
        if name in ("ffn_hidden", "logits", "ssm_inner"):
            m = mdl(shape[-1])
            s = None if m or len(shape) != 3 else seq(shape[1])
            return (b, *([None] * (len(shape) - 3)), s, m)
        if name == "q_blocks":        # (nb, B, qb, K, G, Dh)
            bb = _entry(batch_partition(mesh, shape[1], strategy))
            return (None, bb, seq(shape[2]), None, None, None)
        if name == "hidden_full":     # (B, S, D): the Megatron-SP gather
            return (b, None, None)
        if name == "moe_tokens":
            return (b, None, None)
        if name == "moe_dispatch":
            return (b, None, mdl(shape[2]), None)
        if name == "moe_expert_d":     # (G, E, C, d_model): never shard d
            e = mdl(shape[1])
            if e is None and run.moe_defer_combine:
                return None            # leave partial sums free to defer
            return (b, e, None, None)
        if name == "moe_expert_f":     # (G, E, C, d_ff): TP-in-expert when
            e = mdl(shape[1])          # the expert count doesn't divide
            return (b, e, None, None if e else mdl(shape[-1]))
        return None

    return rules


def replicated(mesh) -> tuple:
    return ()


def format_spec(spec: tuple) -> str:
    """A spec as JAX prints its ``PartitionSpec``."""
    return "PartitionSpec" + repr(tuple(spec))


def describe(shardings, max_rows: int = 0) -> str:
    """Human-readable table of a spec tree (debug/tests): the JAX
    ``describe``'s lines, leaves named by their ``keystr`` paths."""
    rows = [f"{name}: {format_spec(spec)}"
            for name, spec in spec_leaves(shardings)]
    if max_rows:
        rows = rows[:max_rows]
    return "\n".join(rows)


def spec_leaves(tree, path: str = ""):
    """``[(keystr path, spec)]`` of a spec tree, whose leaves are tuples,
    in ``repro_torch.tree.leaves`` order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in spec_leaves(tree[k], f"{path}[{k!r}]")]
    if isinstance(tree, list):
        return [x for i, v in enumerate(tree)
                for x in spec_leaves(v, f"{path}[{i}]")]
    return [(path, tree)]
