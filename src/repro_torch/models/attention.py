"""GQA attention: full-sequence training, prefill (q-block chunked
reference path or the flash kernel) and one-token decode over a dense,
ring or paged KV cache — the port of the JAX package's
``models/attention.py`` for the serving and training paths.  Under
serving tensor parallelism (``serving/tp.py``) a shard holds a slice of
the heads; every function here reads head counts from its tensors, and
:func:`out_proj` is one of the two reduction points.

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
import torch.distributed as dist

from repro_torch.core.actshard import (
    maybe_psum, seq_kv, tp_enter, tp_exit, tp_gather, tp_train,
    tp_will_reduce,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import logits_scale

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
    # contracts the heads — under serving TP each shard holds a partial
    # sum here, hence one cross-shard reduction per attention layer.  The
    # partial stays f32 through it (a product of the upcast operands:
    # exact products, only the summation order differs) and is rounded
    # once, as the one-shard contraction rounds its accumulator once
    w = p["wo"].to(o.dtype)
    if tp_will_reduce("attn_out"):
        part = torch.einsum("bshk,hkd->bsd", o.float(), w.float())
        return maybe_psum(part, "attn_out").to(o.dtype)
    return torch.einsum("bshk,hkd->bsd", o, w)


# ------------------------------------------------- blockwise causal core ----

def softmax_scale(cfg: ModelConfig, Dh: int) -> float:
    """The attention logits' scale: ``cfg.attention_multiplier``, or
    ``Dh ** -0.5`` where the config sets none."""
    return logits_scale(Dh, cfg.attention_multiplier)


def _attend_block(q, k, v, q_pos, kv_pos, window, scale, kv_valid=None):
    """q: (B,qb,K,G,Dh)  k/v: (B,S,K,Dh)  -> (B,qb,K,G,Dh).

    Softmax over the full kv range with causal (+ window) masking, f32
    logits/softmax.  ``kv_valid`` ((S,) bool) excludes pad kv lines
    entirely (front-padded prefill); a query whose kv range masks out
    completely stays NaN-free because ``_NEG_INF`` is finite — its
    softmax is uniform and its output is never consumed."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k).to(f32) * scale
    mask = kv_pos[None, :] <= q_pos[:, None]                 # causal
    if window is not None:
        mask &= (q_pos[:, None] - kv_pos[None, :]) < window  # sliding window
    if kv_valid is not None:
        mask &= kv_valid[None, :]
    logits = torch.where(mask, logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(q.dtype)
    return torch.einsum("bkgqs,bskd->bqkgd", probs, v)


def causal_attention(q, k, v, cfg: ModelConfig, q_block: int = 512,
                     positions: Optional[torch.Tensor] = None,
                     kv_valid: Optional[torch.Tensor] = None,
                     one_block: bool = False):
    """q: (B,S,H,Dh), k/v: (B,S,K,Dh) -> (B,S,H,Dh).  Full/sliding causal,
    q-block chunked so the (S, S) logits are never materialised at once.

    ``positions`` ((S,) int) replaces ``arange(S)`` in the causal mask and
    ``kv_valid`` ((S,) bool) excludes pad kv lines for every query
    (front-padded bucketed prefill).  ``kv_valid`` forces one block, as
    in the JAX version: the q-block loop derives each block's positions
    from ``arange``.  ``one_block`` computes every query row in one block
    (the JAX sequence-parallel route)."""
    B, S, H, Dh = q.shape
    K = k.shape[2]
    G = H // K
    scale = softmax_scale(cfg, Dh)
    window = cfg.sliding_window
    qg = q.reshape(B, S, K, G, Dh)
    kv_pos = torch.arange(S, device=q.device) if positions is None \
        else positions
    if one_block or S <= q_block or kv_valid is not None:
        o = _attend_block(qg, k, v, kv_pos, kv_pos, window, scale,
                          kv_valid=kv_valid)
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

def _kv_of_local_heads(p: dict, cfg: ModelConfig, index: int) -> dict:
    """``p`` with ``wk``/``wv`` (and their biases) cut to the kv heads that
    the ``index``-th rank's query heads read, when the query heads shard
    over the ``model`` ranks and the kv heads do not (GQA with fewer kv
    heads than ranks).  A rank whose query heads fall evenly on its kv
    heads keeps each kv head once; otherwise each query head gets its own
    copy (MHA).  The gradient of the replicated leaves is then partial on
    each rank (``core.zero`` sums it over the ranks)."""
    h_local = p["wq"].shape[1]
    group = cfg.num_heads // cfg.num_kv_heads
    kv = [h // group for h in range(index * h_local, (index + 1) * h_local)]
    uniq = sorted(set(kv))
    if h_local % len(uniq) == 0 and all(
            kv.count(j) == h_local // len(uniq) for j in uniq):
        kv = uniq
    idx = torch.tensor(kv, device=p["wk"].device)
    out = dict(p)
    for name in ("wk", "wv"):
        out[name] = p[name].index_select(1, idx)
    for name in ("bk", "bv"):
        if name in p:
            out[name] = p[name].index_select(0, idx)
    return out


def attention_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    use_kernels: bool = False,
                    one_block: bool = False) -> torch.Tensor:
    """Full-sequence causal attention (training).  x: (B,S,d) -> (B,S,d).
    ``use_kernels`` runs the flash kernel (differentiable through its
    plain version, ``kernels.ops``); otherwise :func:`causal_attention`
    (``one_block``: one q block).  Under training tensor parallelism
    (``core.actshard.tp_train_scope``) with sharded heads the input is
    the column-parallel point and the output projection the reduction
    point.  With the sequence sharded (``seq_parallel``) the block enters
    on the gathered sequence and leaves with this rank's rows (through a
    reduce-scatter, or a slice where the heads are replicated): the flash
    kernel takes one length for q and k, with causal positions from 0."""
    plan = tp_train()
    points = plan is not None and (plan.attn or plan.seq)
    if points:
        x = tp_enter(x)
        if plan.attn and not plan.kv:
            p = _kv_of_local_heads(p, cfg, plan.index)
    S = x.shape[1]
    q, k, v = qkv_proj(p, x, cfg)
    if cfg.pos_embedding == "rope":
        pos = torch.arange(S, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if use_kernels:
        o = kops.flash_attention(q, k, v, window=cfg.sliding_window,
                                 scale=softmax_scale(cfg, q.shape[-1]))
    else:
        o = causal_attention(q, k, v, cfg, one_block=one_block)
    o = out_proj(p, o)
    return tp_exit(o, partial=plan.attn) if points else o


# ---------------------------------------------------------------- caches ----

def init_kv_cache(cfg: ModelConfig, batch: int, cache_len: int,
                  n_groups: int, dtype=torch.bfloat16, device=None,
                  paging=None, kv_heads: Optional[int] = None):
    """Stacked (over layer groups) KV cache for one attention sublayer.

    Dense: ``(G, B, slots, K, Dh)`` with ``slots = min(cache_len,
    window)`` (a ring under a sliding window).  ``paging`` (a
    :class:`repro_torch.models.paging.PagedKVConfig`) makes it one shared
    page pool ``(G, num_pages, page_size, K, Dh)`` addressed through a
    per-slot page table.  ``kv_heads`` replaces ``cfg.num_kv_heads`` for K
    (a tensor-parallel shard's ``K/tp``).  bf16 by default, like the JAX
    cache."""
    K = cfg.num_kv_heads if kv_heads is None else kv_heads
    if paging is not None:
        shape = (n_groups, paging.num_pages, paging.page_size,
                 K, cfg.head_dim)
    else:
        slots = min(cache_len, cfg.sliding_window or cache_len)
        shape = (n_groups, batch, slots, K, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


# --------------------------------------------------------------- prefill ----

def attention_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                      cache_slots: int, use_kernels: bool = False,
                      positions: Optional[torch.Tensor] = None,
                      valid: Optional[torch.Tensor] = None,
                      roll: Optional[int] = None):
    """Prefill: full causal attention + the populated KV lines.

    Returns (out (B,S,d), {"k","v"}).  When ``cache_slots >= S`` the lines
    are the prompt's own ``(B, S, K, Dh)`` — the JAX version pads them with
    zeros to ``cache_slots``; here the caller writes lines ``[0, S)`` and
    the lines past them stay masked at decode until overwritten.  When
    ``cache_slots < S`` (sliding-window ring) the last ``cache_slots``
    positions are kept, laid out at ring indices ``pos % cache_slots``.

    ``positions``/``valid``/``roll`` serve front-padded bucketed prefill
    (hybrid configs, whose SSM sublayers need the real tokens
    chunk-aligned): ``positions`` ((S,) int, negative on the front pad)
    replaces ``arange(S)`` for RoPE and the causal mask, ``valid`` ((S,)
    bool) masks pad kv out of every query, and ``roll`` (the front-pad
    width) rotates the returned lines so the real tokens land at lines
    ``[0, num_real)``, where an unpadded prefill writes them.  The plain
    path runs then: the flash kernel takes no validity mask (the engine
    refuses front-padded buckets under ``run.use_kernels``).
    """
    B, S, _ = x.shape
    q, k, v = qkv_proj(p, x, cfg)
    if cfg.pos_embedding == "rope":
        pos = torch.arange(S, device=x.device) if positions is None \
            else positions
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if valid is not None:
        assert not use_kernels, \
            "front-padded prefill has no kernel path (the flash kernel " \
            "takes no kv-validity mask)"
        o = causal_attention(q, k, v, cfg, positions=positions,
                             kv_valid=valid)
    elif use_kernels:
        o = kops.flash_attention(q, k, v, window=cfg.sliding_window,
                                 scale=softmax_scale(cfg, q.shape[-1]))
    else:
        o = causal_attention(q, k, v, cfg)
    if cache_slots >= S:
        ck, cv = k, v
        if roll is not None:
            ck = torch.roll(k, -int(roll), dims=1)
            cv = torch.roll(v, -int(roll), dims=1)
    else:
        assert roll is None, \
            "front-padded prefill is gated off sliding-window ring caches"
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
    sliding-window ring).  With the cache's lines sharded over the
    training plan's ranks (``core.actshard.seq_kv``) the softmax is
    combined over them (:func:`_decode_seq_sharded`).  Returns (out
    (B,1,d), cache)."""
    B = x.shape[0]
    ck, cv = cache["k"], cache["v"]
    slots = ck.shape[1]
    q, k, v = qkv_proj(p, x, cfg)                     # (B,1,H/K,Dh)
    posv = _positions(pos, B, x.device)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, posv[:, None], cfg.rope_theta)
        k = apply_rope(k, posv[:, None], cfg.rope_theta)
    plan = tp_train()
    if plan is not None and seq_kv():
        assert not use_kernels, \
            "the decode kernel reads a whole cache; this one is sharded"
        o = _decode_seq_sharded(q, k, v, cache, posv, cfg, plan)
        return out_proj(p, o), cache
    bidx = torch.arange(B, device=x.device)
    slot = posv % slots                               # (B,) ring index
    ck.index_put_((bidx, slot), k[:, 0].to(ck.dtype))
    cv.index_put_((bidx, slot), v[:, 0].to(cv.dtype))

    if use_kernels:
        o = kops.flash_decode(q, ck, cv, posv.to(torch.int32),
                              window=cfg.sliding_window,
                              scale=softmax_scale(cfg, q.shape[-1]))
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
                          ck.to(q.dtype)).to(f32) * softmax_scale(cfg, Dh)
    logits = torch.where(valid[:, None, None, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs,
                     cv.to(x.dtype)).reshape(B, 1, H, Dh)
    return out_proj(p, o), cache


def _decode_seq_sharded(q, k, v, cache: dict, posv, cfg: ModelConfig,
                        plan) -> torch.Tensor:
    """Decode attention over a cache whose ring slots are sharded over the
    plan's ranks, rank i holding slots ``[i * n, (i+1) * n)`` of every kv
    head.  The rank owning the new line's slot writes it (``k``/``v``
    hold every kv head: their weights are replicated where the kv heads
    do not divide the ranks).  Every rank scores every query head (its
    own, all-gathered where the heads are sharded) against its slots,
    the running maxima are all-reduced (max), and the exponentials'
    sums and the weighted values (f32) in one all-reduce (sum); the
    rank keeps its own heads of the output.  Returns (B, 1, H_rank,
    Dh)."""
    B = q.shape[0]
    ck, cv = cache["k"], cache["v"]
    n = ck.shape[1]
    slots, first = n * plan.size, plan.index * n
    slot = posv % slots
    mine = (slot >= first) & (slot < first + n)
    line = torch.where(mine, slot - first, 0)
    bidx = torch.arange(B, device=q.device)
    for c, new in ((ck, k), (cv, v)):
        keep = mine[:, None, None]
        c.index_put_((bidx, line), torch.where(keep, new[:, 0].to(c.dtype),
                                               c[bidx, line]))
    h_rank = q.shape[2]
    if plan.attn:
        q = tp_gather(q, 2)
    H, Dh = q.shape[2], q.shape[3]
    K = ck.shape[2]
    qg = q.reshape(B, 1, K, H // K, Dh)
    slot_ids = first + torch.arange(n, device=q.device)
    slot_pos = posv[:, None] - torch.remainder(posv[:, None] - slot_ids[None],
                                               slots)
    valid = (slot_pos >= 0) & (slot_pos <= posv[:, None])
    if cfg.sliding_window is not None:
        valid &= (posv[:, None] - slot_pos) < cfg.sliding_window
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          ck.to(q.dtype)).to(f32) * softmax_scale(cfg, Dh)
    logits = torch.where(valid[:, None, None, None, :], logits, _NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    dist.all_reduce(m, op=dist.ReduceOp.MAX, group=plan.group)
    e = torch.exp(logits - m)                          # (B,K,G,1,n)
    o = torch.einsum("bkgqs,bskd->bqkgd", e, cv.to(f32))
    part = torch.cat([o.reshape(B, -1), e.sum(dim=-1).reshape(B, -1)], -1)
    dist.all_reduce(part, group=plan.group)
    o = part[:, :H * Dh].reshape(B, 1, H, Dh) / part[:, H * Dh:].reshape(
        B, 1, H, 1)
    o = o.to(q.dtype)
    if plan.attn:
        o = o.narrow(2, plan.index * h_rank, h_rank)
    return o


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
                                    posv.to(torch.int32),
                                    scale=softmax_scale(cfg, q.shape[-1]))
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
                          kd.to(q.dtype)).to(f32) * softmax_scale(cfg, Dh)
    logits = torch.where(valid[:, None, None, None, :], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs,
                     vd.to(x.dtype)).reshape(B, 1, H, Dh)
    return out_proj(p, o), cache


# ------------------------------------------ paged prefill and verify ----

def attention_prefill_paged(p: dict, x: torch.Tensor, cache: dict,
                            page_table: torch.Tensor, start,
                            cfg: ModelConfig):
    """Suffix prefill against a prefix already in the paged KV pool: the
    prefix-cache hit path (``start`` page-aligned) and every chunk of a
    chunked prefill (``start`` anywhere, ``models.model.prefill_chunk``).

    x: (B, S, d) hidden states of the suffix tokens, at absolute positions
    ``start + [0, S)``; cache k/v: the pool (num_pages, page_size, K, Dh);
    page_table: (B, n) rows whose first ``ceil(start / page_size)``
    entries map the prefix (the rest null); start: int prefix length.
    The prefix is masked at line granularity (``arange(L) < start``), so
    a partly filled last page gives exactly its live lines.

    Suffix queries attend to [the gathered prefix, the suffix itself
    causally] in one softmax; the two regions' partial sums are taken in
    f32 and cast once, as the JAX version does: a bf16 rounding between
    them would drift the suffix hidden states away from a whole-prompt
    prefill.  The pool is only read — shared prefix pages are never
    written; the suffix K/V lines are returned for the caller to write
    into its own pages.  Plain PyTorch products: the JAX version is
    einsums outside any Pallas kernel.

    Returns (out (B,S,d), {"k","v"} suffix lines (B, S, K, Dh)).
    """
    B, S, _ = x.shape
    q, k, v = qkv_proj(p, x, cfg)
    pos = start + torch.arange(S, device=x.device)
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    H, Dh = q.shape[2], q.shape[3]
    K = k.shape[2]
    G = H // K
    ps = cache["k"].shape[1]
    L = page_table.shape[1] * ps                     # logical prefix width
    scale = softmax_scale(cfg, Dh)
    idx = page_table.to(torch.int64)
    kd = cache["k"][idx].reshape(B, L, K, Dh).to(q.dtype)
    vd = cache["v"][idx].reshape(B, L, K, Dh).to(q.dtype)
    qg = q.reshape(B, S, K, G, Dh)
    # prefix: every suffix query sees every position < start; pool lines
    # at or past start (stale, or the null page) are masked out
    lp = torch.einsum("bqkgd,bskd->bkgqs", qg, kd).to(f32) * scale
    pre_valid = torch.arange(L, device=x.device) < start
    lp = torch.where(pre_valid, lp, _NEG_INF)
    # suffix: causal within itself (a bucketed suffix's pad tail sits at
    # higher positions, so real queries never see it)
    ls = torch.einsum("bqkgd,bskd->bkgqs", qg, k).to(f32) * scale
    ar = torch.arange(S, device=x.device)
    causal = ar[None, :] <= ar[:, None]
    ls = torch.where(causal, ls, _NEG_INF)
    probs = torch.softmax(torch.cat([lp, ls], dim=-1), dim=-1).to(x.dtype)
    o = (torch.einsum("bkgqs,bskd->bqkgd", probs[..., :L].to(f32),
                      vd.to(f32))
         + torch.einsum("bkgqs,bskd->bqkgd", probs[..., L:].to(f32),
                        v.to(f32)))
    o = o.to(x.dtype).reshape(B, S, H, Dh)
    return out_proj(p, o), {"k": k, "v": v}


def attention_verify(p: dict, x: torch.Tensor, cache: dict, pos0,
                     pages: torch.Tensor, offs: torch.Tensor,
                     page_table: torch.Tensor, cfg: ModelConfig):
    """Multi-position decode against the paged pool (speculative verify).

    x: (B, S, d) hidden states of S consecutive tokens per slot (the last
    sampled token, then S-1 drafts) at positions ``pos0 + [0, S)``; pos0:
    (B,) int; pages/offs: (B, S) int physical write targets of each
    token's KV line (the null page past a slot's allocation and for dead
    slots); page_table: (B, n) as in :func:`attention_decode_paged`.

    All S lines are written into the pool **in place** first; then each
    row gathers the pool through the page table and masks ``arange(L) <=
    pos0 + j``, with the scale, einsum strings and cast points of the
    plain path of :func:`attention_decode_paged` — row j is the one-token
    decode at ``pos0 + j``.  Several rows may target the null page at
    once; on CUDA ``index_put_`` then keeps one of the duplicate lines in
    no fixed order, which is harmless only because the null page is
    masked in every read.  Plain PyTorch products: the JAX version is
    einsums outside any Pallas kernel.

    Returns (out (B,S,d), cache)."""
    assert cfg.sliding_window is None, "paged KV is full-attention only"
    B, S, _ = x.shape
    ck, cv = cache["k"], cache["v"]
    ps = ck.shape[1]
    q, k, v = qkv_proj(p, x, cfg)                     # (B,S,H/K,Dh)
    posm = (torch.as_tensor(pos0, device=x.device).to(torch.int64)[:, None]
            + torch.arange(S, device=x.device)[None, :])
    if cfg.pos_embedding == "rope":
        q = apply_rope(q, posm, cfg.rope_theta)
        k = apply_rope(k, posm, cfg.rope_theta)
    pg, of = pages.to(torch.int64), offs.to(torch.int64)
    ck.index_put_((pg, of), k.to(ck.dtype))
    cv.index_put_((pg, of), v.to(cv.dtype))

    H, Dh = q.shape[2], q.shape[3]
    K = ck.shape[2]
    G = H // K
    n_pages = page_table.shape[1]
    L = n_pages * ps
    qg = q.reshape(B, S, K, G, Dh)
    idx = page_table.to(torch.int64)
    kd = ck[idx].reshape(B, L, K, Dh)
    vd = cv[idx].reshape(B, L, K, Dh)
    valid = torch.arange(L, device=x.device)[None, None, :] \
        <= posm[:, :, None]                                   # (B,S,L)
    logits = torch.einsum("bqkgd,bskd->bkgqs", qg,
                          kd.to(q.dtype)).to(f32) * softmax_scale(cfg, Dh)
    logits = torch.where(valid[:, None, None], logits, _NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(x.dtype)
    o = torch.einsum("bkgqs,bskd->bqkgd", probs,
                     vd.to(x.dtype)).reshape(B, S, H, Dh)
    return out_proj(p, o), cache
