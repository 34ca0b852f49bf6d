"""Parallelism strategies — the paper's §2.4/§7 catalog as composable
sharding policies (a copy of the JAX package's ``core/parallelism.py``).

Each :class:`Strategy` says which *logical* tensor axes map onto the mesh's
``model`` axis (tensor/expert parallelism), whether parameters are sharded
along ``data`` (FSDP / ZeRO-3), and which mesh axes carry the batch (data
parallelism).  ``repro_torch.core.sharding`` turns a strategy plus a
parameter spec tree into trees of sharding specs.

The paper presents DP, TP, PP (§7.1) and FSDP/ZeRO-1/2/3 (§7.2); all are
available here.  PP is realized separately (``repro_torch.core.pipeline``)
as a microbatch schedule over a ``pipe`` axis of ranks.
"""
from __future__ import annotations

from dataclasses import dataclass, field

# Priority-ordered logical axes eligible for the `model` mesh axis.  Expert
# parallelism first (all-to-all-style dispatch beats intra-expert TP when the
# expert count divides), then attention heads, then SSD heads/inner, then FFN
# hidden, then vocab.
TP_AXIS_PRIORITY = (
    "experts", "heads", "kv_heads", "ssm_head", "ssm_inner", "ffn", "vocab",
)

# Logical axes that must never be sharded (small / semantically atomic).
NEVER_SHARD = ("head_dim", "conv", "ssm_state", "layers")


@dataclass(frozen=True)
class Strategy:
    """One point in the paper's parallelism catalog."""
    name: str
    tp: bool                          # tensor/expert parallelism on `model`
    fsdp: bool                        # ZeRO-3 parameter sharding on `data`
    batch_axes: tuple[str, ...] = ("pod", "data")
    description: str = ""


STRATEGIES: dict[str, Strategy] = {
    "dp": Strategy(
        "dp", tp=False, fsdp=False,
        description="pure data parallelism (paper §2.4.1): replicate the "
                    "model, shard the batch, all-reduce gradients"),
    "tp": Strategy(
        "tp", tp=True, fsdp=False,
        description="tensor parallelism (paper §7.1 TP): shard heads/ffn/"
                    "experts over `model`, replicate across `data`"),
    "fsdp": Strategy(
        "fsdp", tp=False, fsdp=True,
        description="FSDP/ZeRO-3 (paper §7.2): shard params, grads and "
                    "optimizer state over `data`; all-gather at use"),
    "fsdp_tp": Strategy(
        "fsdp_tp", tp=True, fsdp=True,
        description="composed FSDP x TP — the production default"),
}


def get_strategy(name: str) -> Strategy:
    try:
        return STRATEGIES[name]
    except KeyError:
        if name == "pp":
            raise ValueError(
                "pipeline parallelism is driven via "
                "repro_torch.core.pipeline, not a sharding strategy "
                "name") from None
        raise ValueError(f"unknown strategy {name!r}; "
                         f"have {sorted(STRATEGIES)}") from None
