"""GQA attention: full-sequence training, prefill (q-block chunked
reference path or the flash kernel) and one-token decode over a dense,
ring or paged KV cache — the port of the JAX package's
``models/attention.py`` for the serving and training paths, without
tensor parallelism.

``use_kernels`` routes the attention core through
``repro_torch.kernels.ops`` (the CUDA kernels on the card, their plain
versions on the CPU); otherwise the reference path below runs, which
mirrors the JAX code's cast points: logits in the compute dtype cast to
f32, the finite ``_NEG_INF`` mask, f32 softmax, probs cast back to the
compute dtype before the PV product.

Decode writes the new KV line into the cache **in place**
(``index_put_``) and returns the same cache dict; the JAX functions return
a new cache, and its engine donates the old one.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops

_NEG_INF = -1e30
f32 = torch.float32


# ---------------------------------------------------------------- rotary ----

def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim, 2, dtype=f32, device=device)
                     / head_dim)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Split-half rotation in f32.  x: (..., S, H, Dh); positions:
    (..., S) or (S,)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (Dh/2,)
    angles = positions[..., None].to(f32) * freqs            # (..., S, Dh/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, Dh/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.to(f32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_pe(positions: torch.Tensor, d_model: int) -> torch.Tensor:
    """(S,) -> (S, d_model) classic transformer sinusoidal embedding."""
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0)
                      * torch.arange(half, device=positions.device) / half)
    ang = positions[..., None].to(f32) * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ----------------------------------------------------------- projections ----

def qkv_proj(p: dict, x: torch.Tensor, cfg: ModelConfig):
    dtype = x.dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(dtype))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(dtype))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(dtype))
    if cfg.qkv_bias:
        q = q + p["bq"].to(dtype)
        k = k + p["bk"].to(dtype)
        v = v + p["bv"].to(dtype)
    return q, k, v


def out_proj(p: dict, o: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bshk,hkd->bsd", o, p["wo"].to(o.dtype))


# ------------------------------------------------- blockwise causal core ----

def _attend_block(q, k, v, q_pos, kv_pos, window, scale):
    """q: (B,qb,K,G,Dh)  k/v: (B,S,K,Dh)  -> (B,qb,K,G,Dh).

    Softmax over the full kv range with causal (+ window) masking, f32
    logits/softmax; a query whose kv range masks out completely stays
    NaN-free because ``_NEG_INF`` is finite."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).to(f32) * scale
    mask = kv_pos[None, :] <= q_pos[:, None]                 # causal
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window  # sliding window
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def causal_attention(q, k, v, cfg: ModelConfig, q_block: int = 512):
    """q: (B,S,H,Dh), k/v: (B,S,K,Dh) -> (B,S,H,Dh).  Full/sliding causal,
    q-block chunked so the (S, S) logits are never materialised at once."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = Dh ** -0.5
    window = cfg.sliding_window
    qg = q.reshape(B, S, K, G, Dh)
    kv_pos = torch.arange(S, device=q.device)
    if S <= q_block:
        o = _attend_block(qg, k, v, kv_pos, kv_pos, window, scale)
        return o.reshape(B, S, H, Dh)
    assert S % q_block == 0, (S, q_block)
    # under autograd each block is checkpointed, as the JAX scan body is:
    # otherwise the backward keeps every block's softmax, the full (S, S)
    # probabilities
    attend = (functools.partial(checkpoint, _attend_block,
                                use_reentrant=False)
              if torch.is_grad_enabled() else _attend_block)
    blocks = [attend(qg[:, s:s + q_block], k, v, kv_pos[s:s + q_block],
                     kv_pos, window, scale)
              for s in range(0, S, q_block)]
    return torch.cat(blocks, dim=1).reshape(B, S, H, Dh)


# -------------------------------------------------------------- training ----

def attention_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    use_kernels: bool = False) -> torch.Tensor:
    """Full-sequence causal attention (training).  x: (B,S,d) -> (B,S,d).
    ``use_kernels`` runs the flash kernel (differentiable through its
    plain version, ``kernels.ops``); otherwise :func:`causal_attention`."""
    S = x.shape[1]
    q, k, v = qkv_proj(p, x, cfg)
    if cfg.pos_embedding == "rope":
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if use_kernels:
        o = kops.flash_attention(q, k, v, window=cfg.sliding_window)
    else:
        o = causal_attention(q, k, v, cfg)
    return out_proj(p, o)


# ---------------------------------------------------------------- caches ----

def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  n_groups: int, dtype=torch.bfloat16, device=None,
                  paging=None):
    """Stacked (over layer groups) KV cache for one attention sublayer.

    Dense: ``(G, B, slots, K, Dh)`` with ``slots = min(cache_len,
    window)`` (a ring under a sliding window).  ``paging`` (a
    :class:`repro_torch.models.paging.PagedKVConfig`) makes it one shared
    page pool ``(G, num_pages, page_size, K, Dh)`` addressed through a
    per-slot page table.  bf16 by default, like the JAX cache."""
    if paging is not None:
        shape = (n_groups, paging.num_pages, paging.page_size,
                 cfg.num_kv_heads, cfg.head_dim)
    else:
        slots = min(cache_len, cfg.sliding_window or cache_len)
        shape = (n_groups, batch, slots, cfg.num_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# --------------------------------------------------------------- prefill ----

def attention_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      cache_slots: int, use_kernels: bool = False):
    """Prefill: full causal attention + the populated KV lines.

    Returns (out (B,S,d), {"k","v"}).  When ``cache_slots >= S`` the lines
    are the prompt's own ``(B, S, K, Dh)`` — the JAX version pads them with
    zeros to ``cache_slots``; here the caller writes lines ``[0, S)`` and
    the lines past them stay masked at decode until overwritten.  When
    ``cache_slots < S`` (sliding-window ring) the last ``cache_slots``
    positions are kept, laid out at ring indices ``pos % cache_slots``.
    """
    B, S, _ = x.shape
    q, k, v = qkv_proj(p, x, cfg)
    if cfg.pos_embedding == "rope":
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if use_kernels:
        o = kops.flash_attention(q, k, v, window=cfg.sliding_window)
    else:
        o = causal_attention(q, k, v, cfg)
    if cache_slots >= S:
        ck, cv = k, v
    else:
        # last `slots` positions, placed at ring index pos % slots
        idx = torch.arange(S - cache_slots, S, device=x.device) % cache_slots
        ck = torch.zeros_like(k[:, :cache_slots])
        cv = torch.zeros_like(v[:, :cache_slots])
        ck[:, idx] = k[:, S - cache_slots:]
        cv[:, idx] = v[:, S - cache_slots:]
    return out_proj(p, o), {"k": ck, "v": cv}


# ---------------------------------------------------------------- decode ----

def _positions(pos, B: int, device) -> torch.Tensor:
    """scalar or (B,) positions -> (B,) int64."""
    return torch.broadcast_to(torch.as_tensor(pos, device=device),
                              (B,)).to(torch.int64)


def attention_decode(p: dict, x: torch.Tensor, cache: dict, pos,
                     cfg: ModelConfig, use_kernels: bool = False):
    """One-token decode.  x: (B,1,d); cache k/v: (B, slots, K, Dh); pos:
    scalar or (B,) int — absolute position of each new token (0-based).

    The new K/V line is written **in place** at ring slot ``pos % slots``.
    ``use_kernels`` runs the flash-decode kernel (``window`` marks a
    sliding-window ring).  Returns (out (B,1,d), cache)."""
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    q, k, v = qkv_proj(p, x, cfg)                     # (B,1,H/K,Dh)
    posv = _positions(pos, B, x.device)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, posv[:, None], cfg.rope_theta)
        k = apply_rope(k, posv[:, None], cfg.rope_theta)
    bidx = torch.arange(B, device=x.device)
    slot = posv % slots                               # (B,) ring index
    ck.index_put_((bidx, slot), k[:, 0].to(ck.dtype))
    cv.index_put_((bidx, slot), v[:, 0].to(cv.dtype))

    if use_kernels:
        o = kops.flash_decode(q, ck, cv, posv.to(torch.int32),
                              window=cfg.sliding_window)
        return out_proj(p, o), cache

    H, Dh = q.shape[2], q.shape[3]
    K = ck.shape[2]
    G = H // K
    qg = q.reshape(B, 1, K, G, Dh)
    # absolute position held by each ring slot i:  p - ((p - i) mod slots)
    slot_ids = torch.arange(slots, device=x.device)
    slot_pos = posv[:, None] - torch.remainder(posv[:, None] - slot_ids[None],
                                               slots)
    valid = (slot_pos >= 0) & (slot_pos <= posv[:, None])  # (B, slots)
    if cfg.sliding_window is not None:
        valid &= (posv[:, None] - slot_pos) < cfg.sliding_window
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          ck.to(q.dtype)).to(f32) * (Dh ** -0.5)
    logits = torch.where(valid[:, None, None, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs,
                     cv.to(x.dtype)).reshape(B, 1, H, Dh)
    return out_proj(p, o), cache


def attention_decode_paged(p: dict, x: torch.Tensor, cache: dict, pos,
                           page_table: torch.Tensor, cfg: ModelConfig,
                           use_kernels: bool = False):
    """One-token decode against a paged KV pool.

    x: (B,1,d); cache k/v: (num_pages, page_size, K, Dh) — the shared
    pool; page_table: (B, n_pages) int32 (0 = the null page); pos: scalar
    or (B,) int.  The new line is written **in place** at physical
    ``(page_table[b, pos // ps], pos % ps)``.  A slot whose position lies
    past its row (a finished slot re-feeding its frozen position) writes
    through the row's last entry, as the JAX gather clamps its index;
    such rows are all null pages.  Full-attention only.

    Returns (out (B,1,d), cache)."""
    assert cfg.sliding_window is None, "paged KV is full-attention only"
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    ps = ck.shape[1]
    q, k, v = qkv_proj(p, x, cfg)                     # (B,1,H/K,Dh)
    posv = _positions(pos, B, x.device)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, posv[:, None], cfg.rope_theta)
        k = apply_rope(k, posv[:, None], cfg.rope_theta)
    bidx = torch.arange(B, device=x.device)
    n_pages = page_table.shape[1]
    page = page_table[bidx, (posv // ps).clamp(max=n_pages - 1)].to(
        torch.int64)
    off = posv % ps
    # live slots own disjoint pages; dead/frozen slots all target the null
    # page, whose contents are never read unmasked
    ck.index_put_((page, off), k[:, 0].to(ck.dtype))
    cv.index_put_((page, off), v[:, 0].to(cv.dtype))

    if use_kernels:
        o = kops.flash_decode_paged(q, ck, cv, page_table,
                                    posv.to(torch.int32))
        return out_proj(p, o), cache

    H, Dh = q.shape[2], q.shape[3]
    K = ck.shape[2]
    G = H // K
    qg = q.reshape(B, 1, K, G, Dh)
    idx = page_table.to(torch.int64)
    kd = ck[idx].reshape(B, n_pages * ps, K, Dh)
    vd = cv[idx].reshape(B, n_pages * ps, K, Dh)
    valid = torch.arange(n_pages * ps, device=x.device)[None, :] \
        <= posv[:, None]
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          kd.to(q.dtype)).to(f32) * (Dh ** -0.5)
    logits = torch.where(valid[:, None, None, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs,
                     vd.to(x.dtype)).reshape(B, 1, H, Dh)
    return out_proj(p, o), cache
