"""The Mamba-2 and attention hybrid (Granite 4.0-H's block) in float32:
the token embedding times ``embedding_multiplier``; per layer RMSNorm,
the layer's mixer, its output times ``residual_multiplier`` added back,
RMSNorm, a SwiGLU, its output times ``residual_multiplier`` added back;
a final RMSNorm and the tied output head, the logits divided by
``logits_scaling``.

The mixers, as ``layer_types`` places them:

* ``attention``: grouped-query causal attention without positions (NoPE),
  the logits times ``attention_multiplier``.
* ``mamba``: Mamba-2.  ``z``, ``x``, ``B``, ``C`` and ``dt`` projected
  from the layer's input; a causal depthwise conv with a bias over
  ``[x, B, C]``, then SiLU; ``dt = softplus(dt + dt_bias)``, ``A =
  -exp(A_log)``; the selective scan ``h_t = exp(dt_t A) h_{t-1} + dt_t
  x_t B_t``, ``y_t = C_t . h_t + D x_t`` (one group: B and C shared by
  the heads), written in its chunked dual form (the quadratic form
  inside a chunk of ``mamba_chunk_size``, the state carried from chunk
  to chunk); then ``y * silu(z)`` through an RMSNorm over the inner
  width, and the output projection.

``W`` maps leaf paths to float32 tensors, the layers of a period stacked
on dim 0 (``layers.<i>.`` the i-th layer of every period); ``use``
rounds the operands of every weight product (``common.exact`` for the
reference, ``common.fp8`` for the control)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from reference.common import exact, rmsnorm

f32 = torch.float32
#: query rows of the attention's (rows, S) logits held at once
Q_ROWS = 1024


def _period(c):
    """``(period, offset)`` of ``layer_types``: the attention layer's
    place in each period (``(1, -1)`` without attention)."""
    types = c["layer_types"]
    if "attention" not in types:
        return 1, -1
    n = len(types)
    p = next(p for p in range(1, n + 1) if n % p == 0
             and all(types[i] == types[i % p] for i in range(n)))
    return p, types.index("attention")


def _leaf(W, i, period, name):
    """Layer ``i``'s weight ``name``."""
    return W[f"layers.{i % period}.{name}"][i // period]


def _attention(W, c, i, period, x, use):
    S = x.shape[1]
    q, k, v = (torch.einsum("bsd,dhk->bshk", x,
                            use.w(_leaf(W, i, period, f"attn.{n}")))
               for n in ("wq", "wk", "wv"))
    q, k, v = use.x(q), use.x(k), use.x(v)
    rep = q.shape[2] // k.shape[2]
    k, v = k.repeat_interleave(rep, dim=2), v.repeat_interleave(rep, dim=2)
    pos = torch.arange(S, device=x.device)
    out = []
    for r0 in range(0, S, Q_ROWS):
        rows = slice(r0, min(r0 + Q_ROWS, S))
        s = torch.einsum("bqhd,bkhd->bhqk", q[:, rows], k) \
            * c["attention_multiplier"]
        s = s.masked_fill(pos[None, :] > pos[rows, None], float("-inf"))
        out.append(torch.einsum("bhqk,bkhd->bqhd", torch.softmax(s, -1), v))
    o = torch.cat(out, dim=1)
    return torch.einsum("bshk,hkd->bsd", use.x(o, 2),
                        use.w(_leaf(W, i, period, "attn.wo"), 2))


def ssd(x, dt, A, Bm, Cm, chunk):
    """The selective scan of one layer.  x: (b, S, H, P); dt: (b, S, H)
    after the softplus; A: (H,) negative; Bm/Cm: (b, S, N).  Within a
    chunk of ``chunk`` steps, with cs the cumulative sum of dt A from the
    chunk's start: ``y_q = sum_{k <= q} (C_q . B_k) exp(cs_q - cs_k) dt_k
    x_k + exp(cs_q) C_q . h_in``, and the state leaving the chunk is
    ``h_in exp(cs_end) + sum_k exp(cs_end - cs_k) dt_k x_k B_k^T``.
    Returns y (b, S, H, P) without the D term."""
    b, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros(b, H, P, N, dtype=f32, device=x.device)
    ys = []
    for c0 in range(0, S, chunk):
        sl = slice(c0, min(c0 + chunk, S))
        n = sl.stop - sl.start
        xdt = x[:, sl] * dt[:, sl, :, None]                # (b,n,H,P)
        cs = torch.cumsum(dt[:, sl] * A, dim=1)            # (b,n,H)
        causal = torch.ones(n, n, dtype=torch.bool, device=x.device).tril()
        seg = cs[:, :, None, :] - cs[:, None, :, :]        # (b,q,k,H)
        decay = torch.exp(seg.masked_fill(~causal[None, :, :, None],
                                          float("-inf")))
        cb = torch.einsum("bqn,bkn->bqk", Cm[:, sl], Bm[:, sl])
        y = torch.einsum("bqk,bqkh,bkhp->bqhp", cb, decay, xdt)
        y = y + torch.einsum("bqn,bhpn->bqhp", Cm[:, sl], h) \
            * torch.exp(cs)[..., None]
        ys.append(y)
        to_end = torch.exp(cs[:, -1:] - cs)                # (b,n,H)
        h = h * torch.exp(cs[:, -1])[:, :, None, None] + torch.einsum(
            "bkh,bkhp,bkn->bhpn", to_end, xdt, Bm[:, sl])
    return torch.cat(ys, dim=1)


def _mamba(W, c, i, period, x, use):
    b, S, _ = x.shape
    H, P, N = c["mamba_n_heads"], c["mamba_d_head"], c["mamba_d_state"]
    di = H * P

    def proj(name):
        return x @ use.w(_leaf(W, i, period, f"ssm.{name}"))

    z = proj("wz")
    u = torch.cat([proj("wx"), proj("wB"), proj("wC")], dim=-1)
    w = _leaf(W, i, period, "ssm.conv_w")                  # (width, ch)
    width = w.shape[0]
    up = F.pad(u, (0, 0, width - 1, 0))
    u = sum(up[:, j:j + S] * w[j] for j in range(width)) \
        + _leaf(W, i, period, "ssm.conv_b")
    u = F.silu(u)
    xs = use.x(u[..., :di]).reshape(b, S, H, P)
    Bm, Cm = use.x(u[..., di:di + N]), use.x(u[..., di + N:])
    dt = F.softplus(proj("wdt") + _leaf(W, i, period, "ssm.dt_bias"))
    A = -torch.exp(_leaf(W, i, period, "ssm.A_log"))
    y = ssd(xs, dt, A, Bm, Cm, c["mamba_chunk_size"])
    y = y + xs * _leaf(W, i, period, "ssm.D")[:, None]
    y = y.reshape(b, S, di) * F.silu(z)
    y = rmsnorm(y, _leaf(W, i, period, "ssm.norm_scale"), c["rms_norm_eps"])
    return use.x(y) @ use.w(_leaf(W, i, period, "ssm.wo"))


def _layer(W, c, i, period, offset, h, use):
    eps, m = c["rms_norm_eps"], c["residual_multiplier"]
    x = use.x(rmsnorm(h, _leaf(W, i, period, "norm1.scale"), eps))
    mixer = _attention if i % period == offset else _mamba
    h = h + mixer(W, c, i, period, x, use) * m
    x = use.x(rmsnorm(h, _leaf(W, i, period, "norm2.scale"), eps))
    a = F.silu(x @ use.w(_leaf(W, i, period, "mlp.w1"))) \
        * (x @ use.w(_leaf(W, i, period, "mlp.w3")))
    return h + (use.x(a) @ use.w(_leaf(W, i, period, "mlp.w2"))) * m


def hidden(W, c, tokens, use=exact):
    """Final-normed hidden states (b, S, d) of token rows (b, S)."""
    period, offset = _period(c)
    h = W["embed.tok"][tokens] * c["embedding_multiplier"]
    for i in range(c["num_hidden_layers"]):
        h = use.x(_layer(W, c, i, period, offset, h, use))
    return rmsnorm(h, W["final_norm.scale"], c["rms_norm_eps"])


def unembed(W, c, h, use=exact):
    head = W["embed.tok"] if c.get("tie_word_embeddings") else W["lm_head.w"]
    return (use.x(h) @ use.w(head.T)) / c["logits_scaling"]


def logits(W, c, tokens, start: int, use=exact):
    """Logits (S - start, V) of one sequence (S,) at positions start..S-1."""
    return unembed(W, c, hidden(W, c, tokens[None], use)[0, start:], use)
