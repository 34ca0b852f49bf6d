"""Mixture-of-Experts FFN — GShard-style grouped top-k dispatch with
capacity, shared experts (qwen2-moe), router z-loss and load-balance loss;
the port of the JAX package's ``models/moe.py`` without expert
parallelism.

Tokens are processed in groups of ``moe.group_size`` so the one-hot
dispatch/combine tensors stay O(group * E * capacity) instead of
O(tokens * E * capacity_global).  Capacity is counted per group, so which
tokens overflow depends on how many tokens a call holds and where: a
bucketed prefill's pad tail, a verify round's k + 1 positions and the
frozen tokens of finished decode lanes all take part, in the JAX package
too.

The products are plain ``torch.einsum`` over ``(G, E, C, d)``, as the JAX
version's are einsums outside any Pallas kernel.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
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


def moe_apply(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """x: (B, S, d) -> (y: (B, S, d), aux: dict of scalar losses)."""
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
    ein = torch.einsum("gsec,gsd->gecd", dispatch, xt)             # (G,E,C,d)
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
    y = torch.einsum("gsec,gecd->gsd", combine.to(dtype), eout)

    if moe.num_shared:
        y = y + mlp_apply(p["shared"], xt, cfg.mlp_type)

    y = y.reshape(T_pad, d)[:T]

    aux = {
        "moe_balance_loss": balance_loss,
        "moe_z_loss": z_loss,
        "moe_overflow": 1.0 - torch.mean(
            dispatch.to(f32).sum(dim=(2, 3))) / k,
    }
    return y.reshape(B, S, d), aux
