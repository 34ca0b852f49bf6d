"""Activation sharding hooks of the model code — the port of the JAX
package's ``core/actshard.py``.

Model code stays mesh-agnostic: it calls ``constrain(x, "<logical
name>")`` and ``maybe_psum(x, kind)``, and the caller decides what they
do.  ``constrain`` is the identity here: its rules place activations on a
training mesh, which the port does not build yet.

**Tensor-parallel reductions.**  Serving TP runs one process per shard
(``serving/tp.py``); each holds a slice of the attention heads and of the
FFN hidden dim, so attention's output projection and the MLP
down-projection leave a partial sum on every shard.  Both call
``maybe_psum(x, kind)``; inside :func:`tp_reduce_scope` that is one
``torch.distributed.all_reduce`` over the scope's process group, gated per
kind (``"attn_out"`` | ``"mlp_out"``) and counted.  Outside any scope
(training, one-shard serving) it is the identity.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import torch
import torch.distributed as dist

#: (process group, reduce "attn_out"?, reduce "mlp_out"?, counts or None)
_TP_REDUCE: contextvars.ContextVar[Optional[tuple]] = contextvars.ContextVar(
    "repro_torch_tp_reduce", default=None)


def constrain(x: torch.Tensor, name: str) -> torch.Tensor:
    """The identity: the port installs no activation-sharding rules."""
    return x


@contextlib.contextmanager
def tp_reduce_scope(group, attn: bool, mlp: bool, counts=None):
    """Install cross-shard reductions for model code run inside the block.

    ``group`` is the ``model`` axis's process group.  ``attn``/``mlp`` gate
    the two reduction points independently: a block whose dimension does
    not divide the shard count keeps its weights replicated, and a
    reduction there would multiply its complete result by the shard count.
    ``counts`` (optional dict) accumulates ``{"attn_out": n, "mlp_out":
    m}``, one per all-reduce issued."""
    tok = _TP_REDUCE.set((group, attn, mlp, counts))
    try:
        yield
    finally:
        _TP_REDUCE.reset(tok)


def tp_will_reduce(kind: str) -> bool:
    """True when :func:`maybe_psum` would reduce at this point.  Call sites
    use it to keep the partial contraction in float32 through the
    reduction: summing already-rounded bf16 partials rounds twice, and the
    extra half-ulp can flip a near-tie greedy argmax against the one-shard
    contraction, which rounds its f32 accumulator once."""
    spec = _TP_REDUCE.get()
    if spec is None:
        return False
    _, attn, mlp, _ = spec
    return attn if kind == "attn_out" else mlp


def maybe_psum(x: torch.Tensor, kind: str) -> torch.Tensor:
    """Sum a partial over the scope's shards at a named reduction point
    (``"attn_out"`` | ``"mlp_out"``), in place; the identity outside
    :func:`tp_reduce_scope` or where the point's block is replicated."""
    spec = _TP_REDUCE.get()
    if spec is None:
        return x
    group, attn, mlp, counts = spec
    if (kind == "attn_out" and not attn) or (kind == "mlp_out" and not mlp):
        return x
    if counts is not None:
        counts[kind] = counts.get(kind, 0) + 1
    x = x.contiguous()             # einsum may return a permuted view
    dist.all_reduce(x, group=group)
    return x
