"""Plain PyTorch versions of the attention kernels.

They re-derive the math as naively as possible, as the JAX package's
``kernels/ref.py`` does, in the model layout.  Each computes in f32 and
casts the output to q's dtype, as the kernels do.  The CPU path of
``kernels.ops`` runs them, and ``chip_smoke.py`` holds each CUDA kernel
against its plain version on the card.
"""
from __future__ import annotations

import torch

f32 = torch.float32


def _attend(q, k, v, mask):
    """q: (B, Sq, H, Dh); k/v: (B, Sk, K, Dh); mask broadcastable to
    (B, H, Sq, Sk).  f32 softmax, output in q's dtype."""
    H, Dh = q.shape[2], q.shape[3]
    G = H // k.shape[2]
    kk = k.to(f32).repeat_interleave(G, dim=2)
    vv = v.to(f32).repeat_interleave(G, dim=2)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(f32), kk) * (Dh ** -0.5)
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    o = torch.einsum("bhqk,bkhd->bqhd", probs, vv)
    return o.to(q.dtype)


def attention_ref(q, k, v, window=None):
    """Naive causal (+ sliding window) attention.

    q: (B, S, H, Dh); k/v: (B, S, K, Dh), H % K == 0."""
    S = q.shape[1]
    pos = torch.arange(S, device=q.device)
    mask = pos[None, :] <= pos[:, None]
    if window is not None:
        mask &= (pos[:, None] - pos[None, :]) < window
    return _attend(q, k, v, mask[None, None])


def decode_attention_ref(q, k, v, pos, window=None):
    """Naive single-query decode attention over a dense cache.

    q: (B, 1, H, Dh); k/v: (B, S, K, Dh); pos: (B,) int.  Without
    ``window`` slot i holds position i and sequence b attends slots
    [0, pos_b].  With ``window`` the cache is a ring of S slots: slot i
    holds position ``pos - ((pos - i) mod S)``, attended when written
    (>= 0) and inside the window (the mask of the TPU kernel,
    ``flash_decode.py:70-79``)."""
    S = k.shape[1]
    slot = torch.arange(S, device=q.device)[None, :]
    p = pos.to(torch.int64)[:, None]
    if window is None:
        valid = slot <= p
    else:
        slot_pos = p - torch.remainder(p - slot, S)
        valid = (slot_pos >= 0) & ((p - slot_pos) < window)
    return _attend(q, k, v, valid[:, None, None, :])


def paged_decode_attention_ref(q, k, v, page_table, pos):
    """Naive paged decode attention.

    q: (B, 1, H, Dh); k/v: (num_pages, page_size, K, Dh) shared pool;
    page_table: (B, n_pages) int (0 = null page); pos: (B,) int.
    Gathers the logical (B, n_pages * page_size, K, Dh) view through the
    page table, then defers to :func:`decode_attention_ref`."""
    B, n_pages = page_table.shape
    ps, K, Dh = k.shape[1], k.shape[2], k.shape[3]
    idx = page_table.to(torch.int64)
    kd = k[idx].reshape(B, n_pages * ps, K, Dh)
    vd = v[idx].reshape(B, n_pages * ps, K, Dh)
    return decode_attention_ref(q, kd, vd, pos)
