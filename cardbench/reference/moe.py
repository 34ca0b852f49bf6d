"""Qwen2-MoE's block in float32, as the port computes it: token
embedding; per layer RMSNorm, multi-head attention with q, k and v
biases and rotary positions on the whole head, RMSNorm, a sparse-expert
FFN beside an ungated shared SwiGLU; a final RMSNorm and output head.
The configuration file lists where this block departs from the
published model (``port_departures``).

The expert FFN is GShard's capacity dispatch: a block's tokens, in
order, form groups of ``port_moe.group_size``; the router's float32
softmax picks each token's top ``num_experts_per_tok`` (the lower index
first on a tie), renormalised to sum to 1; the j-th choices of the whole
group take slots after the (j-1)-th, each expert ``capacity`` slots a
group, and a choice past them is dropped.  Its losses: a balance loss
(``num_experts`` x the sum over experts of mean probability x share of
top-1 choices, a group at a time) and a router z-loss (the squared
logsumexp of a token's router logits).  Slots are filled and read back
by index (a gather), which selects what the port's one-hot products
select.

``P`` maps one layer's leaf names (``attn.wq``, ``moe.w1``...) to float32
tensors; ``W`` maps leaf paths to tensors with layers stacked on dim 0;
``use`` rounds the operands of every weight product (``common.exact``
for the reference, ``common.fp8`` for the control).  A control also
rounds the gradient that flows back into each activation it rounds, to
float8 e5m2 with one scale a token (``_x``), as float8 training keeps
its gradients (e4m3 forward, e5m2 backward: Micikevicius et al., "FP8
Formats for Deep Learning", 2022): the program computes its backward
pass in bfloat16 too, so a control whose backward kept float32 would
stand for a float8 forward pass only."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import exact, rmsnorm, rope, xent_sum

f32 = torch.float32
L = "layers.0."


#: largest finite magnitude of float8 e5m2
E5M2_MAX = 57344.0


class _E5m2Back(torch.autograd.Function):
    """The identity, whose gradient is rounded to float8 e5m2 with one
    scale a row of its last ``k`` dimensions."""

    @staticmethod
    def forward(ctx, t, k):
        ctx.k = k
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        m = g.reshape(*g.shape[:g.ndim - ctx.k], -1)
        scale = m.abs().amax(dim=-1, keepdim=True).clamp(min=1e-30) \
            / E5M2_MAX
        q = (m / scale).to(torch.float8_e5m2).to(f32) * scale
        return q.reshape(g.shape), None


def _x(use, t, k: int = 1):
    """An activation as the products take it: as it is for the reference;
    for a control rounded, and its gradient rounded on the way back."""
    if use is exact:
        return t
    return use.x(_E5m2Back.apply(t, k), k)


def layer_params(W, i: int) -> dict:
    """Layer ``i``'s leaves of stacked ``W``, by name within the layer."""
    return {k[len(L):]: W[k][i] for k in W if k.startswith(L)}


def capacity(c) -> int:
    """Slots an expert has a group: ``ceil(group x top_k / experts x
    factor)``, padded to a multiple of 4, at least 4."""
    m = c["port_moe"]
    n = int(math.ceil(m["group_size"] * c["num_experts_per_tok"]
                      / c["num_experts"] * m["capacity_factor"]))
    return max(4, ((n + 3) // 4) * 4)


def _per_expert(use, w):
    """An expert weight (E, rows contracted, cols) rounded with one scale
    an expert's output column."""
    return use.w(w.transpose(0, 1)).transpose(0, 1)


def attention(P, c, x, use=exact):
    S = x.shape[1]
    q, k, v = (torch.einsum("bsd,dhk->bshk", x, use.w(P[f"attn.w{n}"]))
               + P[f"attn.b{n}"] for n in "qkv")
    pos = torch.arange(S, device=x.device)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    q, k, v = _x(use, q), _x(use, k), _x(use, v)
    rep = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    return torch.einsum("bshk,hkd->bsd", _x(use, o, 2),
                        use.w(P["attn.wo"], 2))


def swiglu(P, pre: str, x, use=exact):
    a = F.silu(x @ use.w(P[pre + "w1"])) * (x @ use.w(P[pre + "w3"]))
    return _x(use, a) @ use.w(P[pre + "w2"])


def experts(P, c, x, use=exact):
    """The sparse FFN of normed rows ``x`` (B, S, d), whose B x S tokens
    are whole groups: ``(y, balance, z)``, ``balance`` summed over the
    groups and ``z`` over the tokens (the caller divides by their
    counts)."""
    B, S, d = x.shape
    E, k = c["num_experts"], c["num_experts_per_tok"]
    gs = c["port_moe"]["group_size"]
    if (B * S) % gs:
        raise ValueError(f"{B} x {S} tokens are not whole groups of {gs}")
    G, C = B * S // gs, capacity(c)
    xg = x.reshape(G, gs, d)
    logits = xg @ use.w(P["moe.router"])                          # (G,gs,E)
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    vals, idx = vals[..., :k], idx[..., :k]
    gates = vals / vals.sum(dim=-1, keepdim=True)
    me = probs.mean(dim=1)                                          # (G,E)
    ce = F.one_hot(idx[..., 0], E).to(f32).mean(dim=1)
    balance = E * torch.sum(me * ce)
    z = torch.sum(torch.logsumexp(logits, dim=-1) ** 2)

    # slot of each (token, choice): expert x C + position, or E x C (a
    # dump slot, never read) past the expert's capacity
    counts = torch.zeros((G, E), dtype=torch.int64, device=x.device)
    slots, kept = [], []
    for j in range(k):
        oh = F.one_hot(idx[..., j], E)                              # (G,gs,E)
        pos = torch.sum((torch.cumsum(oh, dim=1) - 1 + counts[:, None, :])
                        * oh, dim=-1)                               # (G,gs)
        within = pos < C
        slots.append(torch.where(within, idx[..., j] * C + pos, E * C))
        kept.append(within)
        counts = counts + oh.sum(dim=1)
    who = torch.full((G, E * C + 1), gs, dtype=torch.int64, device=x.device)
    token = torch.arange(gs, device=x.device).expand(G, gs)
    for s in slots:
        who.scatter_(1, s, token)
    padded = torch.cat([xg, xg.new_zeros(G, 1, d)], dim=1)         # row gs: 0
    ein = torch.gather(padded, 1, who[:, :E * C, None].expand(-1, -1, d))
    ein = _x(use, ein.view(G, E, C, d).transpose(0, 1).reshape(E, G * C, d))
    h = F.silu(torch.bmm(ein, _per_expert(use, P["moe.w1"]))) \
        * torch.bmm(ein, _per_expert(use, P["moe.w3"]))
    out = torch.bmm(_x(use, h), _per_expert(use, P["moe.w2"]))    # (E,GC,d)
    out = out.view(E, G, C, d).transpose(0, 1).reshape(G, E * C, d)
    y = torch.zeros_like(xg)
    for j in range(k):
        at = slots[j].clamp(max=E * C - 1)[..., None].expand(-1, -1, d)
        y = y + torch.gather(out, 1, at) \
            * (gates[..., j] * kept[j])[..., None]
    y = y + swiglu(P, "moe.shared.", xg, use)
    return y.reshape(B, S, d), balance, z


def layer(P, c, h, use=exact):
    """One layer on rows ``h`` (B, S, d): ``(h, balance, z)``, the
    residual stream as the next layer reads it."""
    eps = c["rms_norm_eps"]
    h = h + attention(P, c, _x(use, rmsnorm(h, P["norm1.scale"], eps)), use)
    y, balance, z = experts(P, c, _x(use, rmsnorm(h, P["norm2.scale"], eps)),
                            use)
    return _x(use, h + y), balance, z


def head_xent(W, c, h, labels, mask, use=exact):
    """Summed masked cross entropy of the last layer's rows ``h``."""
    head = W["embed.tok"] if c.get("tie_word_embeddings") else W["lm_head.w"]
    h = rmsnorm(h, W["final_norm.scale"], c["rms_norm_eps"])
    return xent_sum(_x(use, h) @ use.w(head.T), labels, mask)


def hidden(W, c, tokens, use=exact):
    """``(h, balance, z)``: the last layer's rows (B, S, d) of token rows
    (B, S), and the router losses summed over the layers."""
    h = W["embed.tok"][tokens]
    balance = z = 0.0
    for i in range(c["num_hidden_layers"]):
        h, b, zz = layer(layer_params(W, i), c, h, use)
        balance, z = balance + b, z + zz
    return h, balance, z


def loss_parts(W, c, tokens, labels, mask, use=exact) -> tuple:
    """``(xent, balance, z)`` sums of rows (B, S): the loss of a batch is
    ``xent / tokens counted + balance_coef x balance / groups +
    router_z_coef x z / tokens``."""
    h, balance, z = hidden(W, c, tokens, use)
    return head_xent(W, c, h, labels, mask, use), balance, z


def logits(W, c, tokens, start: int, use=exact):
    """Logits (S - start, V) of one sequence (S,) at positions start..S-1
    (the tokens are whole groups)."""
    h = hidden(W, c, tokens[None], use)[0]
    head = W["embed.tok"] if c.get("tie_word_embeddings") else W["lm_head.w"]
    h = rmsnorm(h[0, start:], W["final_norm.scale"], c["rms_norm_eps"])
    return _x(use, h) @ use.w(head.T)
