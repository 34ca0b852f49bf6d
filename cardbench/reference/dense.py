"""A dense attention transformer in float32: token embedding, per layer
RMSNorm, multi-head attention with rotary positions on the whole head,
RMSNorm, SwiGLU, and a final RMSNorm and output head.  The configuration
file lists where this block departs from the published model.

``W`` maps leaf paths to float32 tensors, layers stacked on dim 0;
``use`` rounds the operands of every weight product (``common.exact``
for the reference, ``common.fp8`` for the control)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from reference.common import exact, rmsnorm, rope, xent_sum

L = "layers.0."


def _layer(W, c, i, h, use):
    eps, S = c["norm_eps"], h.shape[1]
    x = use.x(rmsnorm(h, W[L + "norm1.scale"][i], eps))
    q, k, v = (torch.einsum("bsd,dhk->bshk", x, use.w(W[L + f"attn.{n}"][i]))
               for n in ("wq", "wk", "wv"))
    pos = torch.arange(S, device=h.device)
    q, k = rope(q, pos, c["rope_theta"]), rope(k, pos, c["rope_theta"])
    q, k, v = use.x(q), use.x(k), use.x(v)
    rep = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * q.shape[-1] ** -0.5
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, dim=-1), v)
    h = h + torch.einsum("bshk,hkd->bsd", use.x(o, 2),
                         use.w(W[L + "attn.wo"][i], 2))
    x = use.x(rmsnorm(h, W[L + "norm2.scale"][i], eps))
    a = F.silu(x @ use.w(W[L + "mlp.w1"][i])) * (x @ use.w(W[L + "mlp.w3"][i]))
    return h + use.x(a) @ use.w(W[L + "mlp.w2"][i])


def hidden(W, c, tokens, use=exact, remat=False):
    """Final-normed hidden states (B, S, d) of token rows (B, S)."""
    h = W["embed.tok"][tokens]
    for i in range(c["num_hidden_layers"]):
        if remat:
            h = checkpoint(_layer, W, c, i, h, use, use_reentrant=False)
        else:
            h = _layer(W, c, i, h, use)
        h = use.x(h)                   # the residual stream as stored
    return rmsnorm(h, W["final_norm.scale"], c["norm_eps"])


def unembed(W, c, h, use=exact):
    head = W["embed.tok"] if c.get("tie_word_embeddings") else W["lm_head.w"]
    return use.x(h) @ use.w(head.T)


def logits(W, c, tokens, start: int, use=exact):
    """Logits (S - start, V) of one sequence (S,) at positions start..S-1."""
    return unembed(W, c, hidden(W, c, tokens[None], use)[0, start:], use)


def loss_sum(W, c, tokens, labels, mask, use=exact):
    """Summed masked cross entropy of rows (B, S), layers recomputed in
    the backward pass to hold one layer's activations."""
    h = hidden(W, c, tokens, use, remat=True)
    return xent_sum(unembed(W, c, h, use), labels, mask)
