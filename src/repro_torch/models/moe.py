"""Mixture-of-Experts FFN — GShard-style grouped top-k dispatch with
capacity, shared experts (qwen2-moe), router z-loss and load-balance loss;
the port of the JAX package's ``models/moe.py``.

Tokens are processed in groups of ``moe.group_size`` so the one-hot
dispatch/combine tensors stay O(group * E * capacity) instead of
O(tokens * E * capacity_global).  Capacity is counted per group, so which
tokens overflow depends on how many tokens a call holds and where: a
bucketed prefill's pad tail, a verify round's k + 1 positions and the
frozen tokens of finished decode lanes all take part, in the JAX package
too.

The products are plain ``torch.einsum`` over ``(G, E, C, d)``, as the JAX
version's are einsums outside any Pallas kernel.

Under a training TP plan (``core.actshard.tp_train_scope``) that shards
any of the block's weights, the block runs between points
(``tp_enter``/``tp_exit``).  Routing, capacity and the aux losses are
computed whole on every rank from the whole token rows.  With the
experts on ``model`` (expert parallelism) a rank runs the dispatch and
combine of its ``E/m`` experts, and the combine leaves a partial ``y``.
Where the expert count does not divide, each expert's ``d_ff`` shards
(TP-in-expert) and the expert outputs ``(G, E, C, d)`` are partial:
they are summed over the ranks before the combine, or, under
``run.moe_defer_combine``, the combine runs on the partial outputs and
``y`` is summed after it.  The shared experts are column/row-parallel
like a dense MLP.  Inside the points every gradient is a share
(``core.actshard``): the router is a partial leaf, and the aux losses,
whole on every rank, pass through ``tp_share``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.actshard import (
    tp_enter, tp_exit, tp_share, tp_sum, tp_train,
)
from repro_torch.models.mlp import mlp_apply

f32 = torch.float32


def _capacity(group: int, top_k: int, num_experts: int, factor: float) -> int:
    c = int(math.ceil(group * top_k / num_experts * factor))
    return max(4, ((c + 3) // 4) * 4)  # pad to a multiple of 4


def _top_k(probs: torch.Tensor, k: int):
    """``jax.lax.top_k``: the k largest along the last axis, the lower
    index first on a tie (a stable descending sort; ``torch.topk`` gives
    no order for ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig,
              defer_combine: bool = False):
    """x: (B, S, d) -> (y: (B, S, d), aux: dict of scalar losses).
    ``defer_combine`` (``run.moe_defer_combine``): under TP-in-expert,
    sum the partial sums after the combine, on ``y``."""
    plan = tp_train()
    points = plan is not None and (plan.experts or plan.expert_ffn
                                   or plan.shared or plan.seq)
    if points:
        x = tp_enter(x)
    moe = cfg.moe
    B, S, d = x.shape
    E, k = moe.num_experts, moe.top_k
    T = B * S
    gs = min(moe.group_size, T)
    xt = x.reshape(T, d)
    T_pad = ((T + gs - 1) // gs) * gs
    if T_pad != T:
        # padded tokens route like real ones but are sliced off at the end;
        # capacity waste is bounded by one group.
        xt = F.pad(xt, (0, 0, 0, T_pad - T))
    G = T_pad // gs
    C = _capacity(gs, k, E, moe.capacity_factor)
    dtype = x.dtype

    xt = xt.reshape(G, gs, d)
    logits = (xt @ p["router"].to(dtype)).to(f32)                 # (G,gs,E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = _top_k(probs, k)                         # (G,gs,k)
    gate_vals = gate_vals / torch.sum(gate_vals, dim=-1, keepdim=True)

    # ---- aux losses (Switch/GShard) ----
    me = torch.mean(probs, dim=1)                                  # (G,E)
    ce = torch.mean(F.one_hot(gate_idx[..., 0], E).to(f32), dim=1)  # (G,E)
    balance_loss = E * torch.mean(torch.sum(me * ce, dim=-1))
    z_loss = torch.mean(torch.square(torch.logsumexp(logits, dim=-1)))

    # ---- capacity-based dispatch ----
    dispatch = torch.zeros((G, gs, E, C), dtype=dtype, device=x.device)
    combine = torch.zeros((G, gs, E, C), dtype=f32, device=x.device)
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    for j in range(k):
        oh = F.one_hot(gate_idx[..., j], E)                        # (G,gs,E)
        pos = torch.cumsum(oh, dim=1) - 1 + counts[:, None, :]     # (G,gs,E)
        pos_j = torch.sum(pos * oh, dim=-1)                        # (G,gs)
        within = pos_j < C
        sel = oh * within[..., None]                               # (G,gs,E)
        # jax.nn.one_hot gives an all-zero row for an index >= C (a token
        # past its expert's capacity); F.one_hot raises there, so such
        # rows take index 0 and are zeroed
        cap_oh = F.one_hot(torch.where(within, pos_j, 0), C).to(f32) \
            * within[..., None]                                    # (G,gs,C)
        d_j = sel[..., :, None].to(f32) * cap_oh[..., None, :]
        dispatch = dispatch + d_j.to(dtype)
        combine = combine + d_j * gate_vals[..., j][..., None, None]
        counts = counts + torch.sum(oh, dim=1)

    # ---- expert compute (einsum over capacity slots) ----
    ep = points and plan.experts
    tpe = points and plan.expert_ffn
    comb = combine.to(dtype)
    disp = dispatch
    if ep:                                  # this rank's E/m experts
        n = p["w1"].shape[0]
        disp = dispatch.narrow(2, plan.index * n, n)
        comb = comb.narrow(2, plan.index * n, n)
    ein = torch.einsum("gsec,gsd->gecd", disp, xt)                 # (G,E,C,d)
    h = torch.einsum("gecd,edf->gecf", ein, p["w1"].to(dtype))
    if cfg.mlp_type == "swiglu":
        h = F.silu(h) * torch.einsum("gecd,edf->gecf", ein,
                                     p["w3"].to(dtype))
    elif cfg.mlp_type == "gelu":
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h, approximate="tanh")
    else:
        h = torch.square(F.relu(h))
    eout = torch.einsum("gecf,efd->gecd", h, p["w2"].to(dtype))   # (G,E,C,d)
    routed_partial = ep or (tpe and defer_combine)
    if tpe and not defer_combine:
        eout = tp_sum(eout)
    y = torch.einsum("gsec,gecd->gsd", comb, eout)

    # the routed and shared outputs, each partial (summed over the ranks
    # at the exit) or whole; the parts of one kind share their exit
    parts = {True: [], False: []}
    parts[bool(routed_partial)].append(y)
    if moe.num_shared:
        parts[bool(points and plan.shared)].append(
            mlp_apply(p["shared"], xt, cfg.mlp_type))
    y = None
    for partial, ys in parts.items():
        if not ys:
            continue
        part = sum(ys[1:], ys[0]).reshape(T_pad, d)[:T].reshape(B, S, d)
        if points:
            part = tp_exit(part, partial)
        y = part if y is None else y + part

    if points:
        balance_loss, z_loss = tp_share(balance_loss), tp_share(z_loss)
    aux = {
        "moe_balance_loss": balance_loss,
        "moe_z_loss": z_loss,
        "moe_overflow": 1.0 - torch.mean(
            dispatch.to(f32).sum(dim=(2, 3))) / k,
    }
    return y, aux
