"""Which dimension of a parameter shards under serving tensor parallelism —
the serving half of the JAX package's ``core/sharding.py``
(``serving_param_pspec``).

The training half (``param_pspec``, optimizer-state and batch shardings,
activation rules) maps logical axes onto a data/model mesh; the port does
not build that mesh yet.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.models.spec import ParamSpec


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
