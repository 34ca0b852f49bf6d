"""Model assembly: embedding/frontends -> layer groups -> LM head — the
port of the JAX package's ``models/model.py`` for every model family
(dense attention, SSM, hybrid, MoE, the vision and audio stubs).

Entry points (plain functions of (params, inputs, cache)):
  * ``forward_train(params, batch, cfg, run)``  -> (logits, aux)
  * ``loss_fn(params, batch, cfg, run)``        -> (loss, metrics)
  * ``prefill(params, batch, cfg, run)``        -> (logits, cache slice)
  * ``decode_step(params, cache, token, pos, cfg, run)`` -> (logits, cache)
  * ``decode_n(params, cache, token, pos, ...)`` -> N tokens per call with
    on-device sampling and per-slot stop masking (one host sync per chunk);
    with ``graphs=`` (a ``DecodeGraphs``) its token steps replay a CUDA
    graph on the card
  * ``prefill_suffix`` / ``prefill_chunk`` -> a prompt's tail against
    lines already in the paged pool (prefix-cache hits, chunked prefill)
  * ``verify_tokens`` -> k+1 positions per slot in one call (speculative
    verify)

Parameters are the JAX package's tree: layer groups stacked on dim 0 with
period ``group_period(cfg)``; a Python loop over groups replaces
``lax.scan``; under ``run.remat`` ("layer" or "full") each group runs
inside ``torch.utils.checkpoint`` as the JAX scan body runs inside
``jax.checkpoint``.  Decode updates the KV cache and the SSM state in
place.  ``run.use_kernels`` routes attention and the training SSD scan
through the CUDA kernels (``kernels.ops``).

Modality frontends (vision/audio) are stubs, as in the JAX package: the
batch carries precomputed prefix/frame embeddings and this module
consumes them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.core.actshard import (
    collectives_scoped, seq_gather, seq_slice, snapshot, tp_enter, tp_exit,
    tp_gather_last, tp_reduce, tp_share, tp_sum, tp_train, tp_train_scope,
    use_params,
)
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import moe as MOE
from repro_torch.models import ssm as SSM
from repro_torch.models.init import torch_dtype
from repro_torch.models.mlp import mlp_apply, rmsnorm
from repro_torch.models.spec import group_period, layer_schedule
from repro_torch.monitoring.metrics import (
    METRIC_SERVE_DECODE_EAGER_STEPS, METRIC_SERVE_DECODE_GRAPH_CAPTURES,
    METRIC_SERVE_DECODE_GRAPH_REPLAYS, MetricsRegistry,
)
from repro_torch.monitoring.trace import SPANS

#: token emitted by finished slots inside a decode_n chunk (host drops them)
PAD_TOKEN_ID = 0
AUX_KEYS = ("moe_balance_loss", "moe_z_loss")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def cast_for_compute(params, dtype: torch.dtype):
    """Cast every weight that the model casts to the compute dtype at use
    (matrices, embeddings, biases) once, up front — the same numbers as
    casting at every use.  Norm scales stay in their storage dtype: the
    model reads them in f32."""
    if isinstance(params, dict):
        return {k: (v if k == "scale" else cast_for_compute(v, dtype))
                for k, v in params.items()}
    if isinstance(params, list):
        return [cast_for_compute(v, dtype) for v in params]
    return params.to(dtype)


def _take(tree, g: int):
    """The group-``g`` slice of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    return tree[g]


def _use_group(params, g: int, P: int) -> list:
    """Group ``g``'s sublayer trees as the model uses them
    (``core.actshard.use_params``: the views themselves outside every
    scope)."""
    return use_params([_take(params["layers"][i], g) for i in range(P)],
                      "layers")


def _groups(params) -> int:
    leaf = params["layers"][0]["norm1"]["scale"]
    return leaf.shape[0]


# ------------------------------------------------------------ embeddings ----

def times(t, m: float):
    """``t * m``; ``t`` itself where ``m`` is 1, so that a config without
    muP scalars runs the same operations as before they existed."""
    return t if m == 1.0 else t * m


def residual(x, h, cfg: ModelConfig):
    """A sublayer's residual add: ``x + h * cfg.residual_multiplier``."""
    return x + times(h, cfg.residual_multiplier)


def embed_tokens(params, tokens, cfg: ModelConfig):
    """The tokens' rows of the embedding, times
    ``cfg.embedding_multiplier``."""
    return times(_lookup(params, tokens, cfg), cfg.embedding_multiplier)


def _lookup(params, tokens, cfg: ModelConfig):
    tab = params["embed"]["tok"].to(compute_dtype(cfg))
    plan = tp_train()
    if plan is None or not plan.vocab:
        return tab[tokens]
    # vocab-parallel: each model rank holds rows [index * V/m, ...) of the
    # table, looks up the tokens that fall there (zeros elsewhere), and
    # the reduction point sums the one nonzero row of each token (both
    # ways when the rows are sliced after it: the gradient is then a share)
    n = tab.shape[0]
    local = tokens - plan.index * n
    hit = (local >= 0) & (local < n)
    h = tab[torch.where(hit, local, 0)] * hit[..., None].to(tab.dtype)
    return tp_sum(h) if plan.seq else tp_reduce(h)


def build_hidden(params, batch: dict, cfg: ModelConfig):
    """Input hidden states from tokens and/or stub embeddings: the VLM
    stub's ``prefix_embeddings`` and the audio stub's
    ``frame_embeddings`` go ahead of the tokens, and sinusoidal PE spans
    the whole length.  With the sequence sharded over the training TP
    ranks, this rank's rows of them."""
    dtype = compute_dtype(cfg)
    parts = []
    if "prefix_embeddings" in batch:                 # vlm: ViT stub output
        parts.append(batch["prefix_embeddings"].to(dtype))
    if "frame_embeddings" in batch:                  # audio: codec stub
        parts.append(batch["frame_embeddings"].to(dtype))
    if "tokens" in batch:
        parts.append(embed_tokens(params, batch["tokens"], cfg))
    h = parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)
    return seq_slice(add_positions(h, 0, cfg))


def add_positions(h, start, cfg: ModelConfig):
    """``h`` (B, S, d) plus the sinusoidal embedding of its rows' absolute
    positions ``start + [0, S)`` (``start``: an int, or a scalar or (B,)
    tensor of each sequence's first position); ``h`` itself under rotary
    positions or none."""
    if cfg.pos_embedding != "sinusoidal":
        return h
    S = h.shape[1]
    if isinstance(start, int):
        pos = torch.arange(start, start + S, device=h.device)
    else:
        pos = (torch.as_tensor(start, device=h.device).reshape(-1, 1)
               + torch.arange(S, device=h.device))
    return h + A.sinusoidal_pe(pos, cfg.d_model).to(h.dtype)


def hidden_len(batch: dict) -> int:
    """The sequence length :func:`build_hidden` makes of ``batch``."""
    return sum(batch[k].shape[1] for k in ("prefix_embeddings",
                                            "frame_embeddings", "tokens")
               if k in batch)


def unembed(params, h, cfg: ModelConfig):
    """Logits of the final hidden states, divided by
    ``cfg.logits_scaling``."""
    logits = _head(params, h, cfg)
    ls = cfg.logits_scaling
    return logits if ls == 1.0 else logits / ls


def _head(params, h, cfg: ModelConfig):
    w = params["embed"]["tok"] if cfg.tie_embeddings else params["lm_head"]["w"]
    plan = tp_train()
    if plan is None or not (plan.vocab or plan.seq):
        return torch.einsum("bsd,vd->bsv", h, w.to(h.dtype))
    if not plan.vocab:
        # a replicated head on the gathered rows: every rank computes the
        # whole logits, whose gradient becomes a share
        return tp_share(torch.einsum("bsd,vd->bsv", seq_gather(h),
                                     w.to(h.dtype)))
    # vocab-parallel head: this rank's logits columns, gathered along vocab
    # in f32 (the cross entropy's dtype) for the loss, whose gradient each
    # rank slices back
    return tp_gather_last(torch.einsum("bsd,vd->bsv", tp_enter(h),
                                       w.to(h.dtype)).float())


# -------------------------------------------------------------- training ----

def _zeros_aux(device):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def _ffn(p, x, ffn: str, cfg: ModelConfig, run: Optional[RunConfig] = None,
         aux: Optional[dict] = None):
    """The sublayer's FFN half (dense, MoE or none) with its residual;
    returns ``(x, aux)``.

    Training passes its ``run`` and its aux sums: the MoE aux terms add
    into ``aux``, the MoE combine follows ``run.moe_defer_combine``, and a
    dense block under a training TP plan runs column- then row-parallel
    (Megatron).  Serving passes neither: the MoE combine is the plain one,
    its aux terms are dropped, and a dense block runs as the serving TP
    scope shards it (its reduction is inside ``mlp_apply``)."""
    if ffn == "none":
        return x, aux
    h = rmsnorm(x, p["norm2"]["scale"], cfg.norm_eps)
    if ffn == "moe":
        h, moe_aux = MOE.moe_apply(
            p["moe"], h, cfg,
            defer_combine=run is not None and run.moe_defer_combine)
        if aux is not None:
            aux = {k: aux[k] + moe_aux[k] for k in AUX_KEYS}
    else:
        plan = None if run is None else tp_train()
        if plan is not None and plan.mlp:
            # column-parallel w1/w3, row-parallel w2 (Megatron)
            h = tp_exit(mlp_apply(p["mlp"], tp_enter(h), cfg.mlp_type),
                        partial=True)
        else:
            # replicated: a position-wise block runs on the rows as they
            # are (this rank's, with the sequence sharded)
            h = mlp_apply(p["mlp"], h, cfg.mlp_type)
    return residual(x, h, cfg), aux


def sublayer_train(p, x, mixer: str, ffn: str, cfg: ModelConfig,
                   run: RunConfig):
    aux = _zeros_aux(x.device)
    h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps)
    if mixer == "attn":
        h = A.attention_train(p["attn"], h, cfg, use_kernels=run.use_kernels,
                              one_block=run.seq_parallel)
    else:
        h = SSM.ssm_train(p["ssm"], h, cfg, use_kernels=run.use_kernels)
    return _ffn(p, residual(x, h, cfg), ffn, cfg, run, aux)


def backbone_train(params, h, cfg: ModelConfig, run: RunConfig):
    """The layer groups in a Python loop; returns (h, aux sums).  Under
    ``run.remat`` in ("layer", "full") each group is recomputed in the
    backward pass instead of keeping its activations.

    Each group's parameters go into its body as the rank holds them and
    are gathered there (``use_params``): under ZeRO-3 the gathered
    weights are then not kept for the backward pass, which gathers them
    again, as the JAX scan under ``jax.checkpoint`` does."""
    P = group_period(cfg)
    sched = layer_schedule(cfg)[:P]
    # a recomputed body runs in the backward pass, where (on the card) the
    # scopes installed around this call are not set: it installs its own
    scopes = snapshot()

    def group_body(x, group_params):
        with scopes():
            group_params = use_params(group_params, "layers")
            acc = _zeros_aux(x.device)
            for i, (mixer, ffn) in enumerate(sched):
                x, aux = sublayer_train(group_params[i], x, mixer, ffn, cfg,
                                        run)
                acc = {k: acc[k] + aux[k] for k in AUX_KEYS}
        return x, acc

    if run.remat not in ("none", "layer", "full"):
        raise ValueError(f"remat {run.remat!r}: none | layer | full")
    acc = _zeros_aux(h.device)
    for g in range(_groups(params)):
        gp = [_take(params["layers"][i], g) for i in range(P)]
        if run.remat == "none":
            h, aux = group_body(h, gp)
        else:
            h, aux = checkpoint(group_body, h, gp, use_reentrant=False)
        acc = {k: acc[k] + aux[k] for k in AUX_KEYS}
    return h, acc


def forward_train(params, batch: dict, cfg: ModelConfig, run: RunConfig):
    """(logits, aux).  Under a training TP plan with ``seq_parallel``
    whose ranks divide the sequence, the residual stream between blocks
    holds this rank's rows (Megatron-SP): the norms act on them, each
    block enters on the gathered sequence, and the LM head gathers it
    before the vocab-parallel product."""
    params = use_params(params, "root")
    plan = tp_train()
    seq = plan is not None and plan.seq_rows(hidden_len(batch))
    with tp_train_scope(dataclasses.replace(plan, seq=True) if seq
                        else plan):
        h = build_hidden(params, batch, cfg)
        h, aux = backbone_train(params, h, cfg, run)
        h = rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
        return unembed(params, h, cfg), aux


def softmax_xent(logits, labels, mask, group=None):
    """Mean cross entropy over the tokens where ``mask`` is set, in f32
    (the JAX one-hot sum, written as a gather).  With ``group`` (the data
    ranks of a mesh, each holding its rows of the batch) the mask count
    is summed over the group, so the ranks' terms add up to the mean over
    the global batch: a mean of per-rank means is wrong whenever the
    masks differ."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.to(torch.int64)[..., None])[..., 0]
    per_tok = (lse - ll) * mask
    count = torch.sum(mask)
    if group is not None:
        count = count.detach().clone()
        dist.all_reduce(count, group=group)
    return torch.sum(per_tok) / torch.clamp(count, min=1.0)


def loss_fn(params, batch: dict, cfg: ModelConfig, run: RunConfig,
            group=None):
    """(loss, metrics).  With ``group`` (see :func:`softmax_xent`) both
    are this rank's share of the global batch's, to be summed over the
    group: the MoE aux terms, means over token groups that each lie in
    one rank's rows, are divided by the group's size."""
    logits, aux = forward_train(params, batch, cfg, run)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(batch["labels"].shape, dtype=torch.float32,
                          device=logits.device)
    xent = softmax_xent(logits, batch["labels"], mask, group)
    if group is not None:
        share = 1.0 / dist.get_world_size(group)
        aux = {k: aux[k] * share for k in AUX_KEYS}
    loss = xent
    if cfg.moe is not None:
        loss = (loss + cfg.moe.balance_coef * aux["moe_balance_loss"]
                + cfg.moe.router_z_coef * aux["moe_z_loss"])
    metrics = {"loss": loss, "xent": xent, **aux}
    return loss, metrics


# ----------------------------------------------------------------- cache ----

def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               paging=None, kv_heads: Optional[int] = None,
               abstract: bool = False):
    """Decode cache: one entry per sublayer slot, stacked over groups —
    ``{"k", "v"}`` for an attention sublayer, ``{"state", "conv"}`` for
    an SSM one.  ``paging`` makes every attention sublayer a shared page
    pool; an SSM sublayer's state is not line-addressable and keeps its
    per-slot rows (``batch`` of them) beside the pool.  ``kv_heads`` sizes the
    attention leaves' kv-head axis (a tensor-parallel shard's ``K/tp``;
    default ``cfg.num_kv_heads``).  ``abstract`` puts the cache on the
    ``meta`` device (the dry run's; ``device`` is then ignored)."""
    if abstract:
        device = torch.device("meta")
    P = group_period(cfg)
    n_groups = cfg.num_layers // P
    layers = []
    for mixer, _ in layer_schedule(cfg)[:P]:
        if mixer == "attn":
            layers.append(A.init_kv_cache(cfg, batch, cache_len, n_groups,
                                          device=device, paging=paging,
                                          kv_heads=kv_heads))
        else:
            layers.append(SSM.init_ssm_cache(cfg, batch, n_groups,
                                             device=device))
    return {"layers": layers}


def cache_logical_axes(cfg: ModelConfig, paging: bool = False):
    """Logical axes tree matching :func:`init_cache`."""
    P = group_period(cfg)
    layers = []
    for mixer, _ in layer_schedule(cfg)[:P]:
        if mixer == "attn":
            # paged pools have no batch dim: pages replace (batch, seq)
            ax = (("layers", None, "cache_seq", "kv_heads", "head_dim")
                  if paging else
                  ("layers", "batch", "cache_seq", "kv_heads", "head_dim"))
            layers.append({"k": ax, "v": ax})
        else:
            layers.append({
                "state": ("layers", "batch", "ssm_head", None, "ssm_state"),
                "conv": ("layers", "batch", "conv", None),
            })
    return {"layers": layers}


def cache_kv_head_dim(cfg: ModelConfig, paging: bool = False) -> int:
    """Index of the ``kv_heads`` axis in every attention KV-cache leaf.

    Every engine-level cache layout — the paged pool ``(G, pages, ps, K,
    Dh)``, dense rows ``(G, B, slots, K, Dh)`` and one-request prefill or
    chunk slices ``(G, B, S, K, Dh)`` — carries ``kv_heads`` at the same
    position, the axis serving TP splits (``serving.tp.cache_pspec``).
    Derived from :func:`cache_logical_axes`, so a layout change breaks
    here loudly instead of splitting the wrong axis."""
    for leaf in cache_logical_axes(cfg, paging=paging)["layers"]:
        for axes in leaf.values():
            if "kv_heads" in axes:
                return axes.index("kv_heads")
    raise ValueError(
        f"no attention KV leaf in the cache for cfg with ssm={cfg.ssm!r}")


# --------------------------------------------------------------- prefill ----

def _stack_caches(per_group: list) -> list:
    """[group][slot] cache dicts -> per slot, each leaf stacked over the
    groups."""
    return [{name: torch.stack([g[i][name] for g in per_group])
             for name in per_group[0][i]}
            for i in range(len(per_group[0]))]


def _attn_only(cfg: ModelConfig) -> bool:
    return all(mixer == "attn" for mixer, _ in layer_schedule(cfg))


#: span name of a sublayer's sequence mixer (traced calls, ``SPANS``).
#: Layer spans are timed on the host only (a timing event costs ~20-90 us
#: of host time between the decode step's launches on an H100), from one
#: clock reading a boundary, made into spans once the loop is done
#: (``SpanScope.layers``).
_MIXER_SPAN = {"attn": "attention", "ssm": "ssm"}
#: the same in a prefill, where an SSM sublayer runs the chunked scan
_PREFILL_MIXER_SPAN = {"attn": "attention", "ssm": "ssm_prefill"}


def _layer_names(sched, sublayers: int, mixer_span: dict) -> list:
    """The span names of ``sublayers`` sublayers run in the schedule's
    order: the mixer's (``mixer_span``), then ``ffn``."""
    period = [n for mixer, _ in sched for n in (mixer_span[mixer], "ffn")]
    return period * (sublayers // len(sched))


def _layers(params, h, cfg: ModelConfig, mix, cache=None, spans=None):
    """Run ``h`` through every layer group and sublayer of the schedule, as
    every serving entry point does: ``norm1``, the sequence mixer, the
    residual, then the FFN half (:func:`_ffn`).

    ``mix(mixer, p, x, c) -> (y, out)`` is the entry point's mixer call:
    ``mixer`` the schedule's ("attn" or "ssm"), ``p`` the sublayer's
    weights, ``x`` the normed hidden states, ``c`` the sublayer's group
    slice of ``cache`` (None without one).  With ``spans`` (mixer -> span
    name) and a span scope set, the sublayers are recorded as layer
    spans.  Returns ``(h, outs)``, ``outs[group][slot]`` each sublayer's
    ``out``."""
    P = group_period(cfg)
    sched = layer_schedule(cfg)[:P]
    sc = None if spans is None else SPANS.get()
    marks = [] if sc is not None else None
    per_group = []
    for g in range(_groups(params)):
        outs = []
        gp = _use_group(params, g, P)
        for i, (mixer, ffn) in enumerate(sched):
            p = gp[i]
            c = None if cache is None else _take(cache["layers"][i], g)
            if marks is not None:
                marks.append(sc.tracer.clock())
            hh, out = mix(mixer, p,
                          rmsnorm(h, p["norm1"]["scale"], cfg.norm_eps), c)
            if marks is not None:
                marks.append(sc.tracer.clock())
            h, _ = _ffn(p, residual(h, hh, cfg), ffn, cfg)
            outs.append(out)
        per_group.append(outs)
    if marks is not None:
        marks.append(sc.tracer.clock())
        sc.layers(_layer_names(sched, len(marks) // 2, spans), marks,
                  "model")
    return h, per_group


def prefill(params, batch: dict, cfg: ModelConfig, run: RunConfig,
            cache_len: Optional[int] = None,
            last_pos: Optional[int] = None,
            front_pad: Optional[int] = None,
            num_real: Optional[int] = None):
    """Run the full prompt, return (logits (B,1,V), cache slice).

    ``last_pos`` selects which position's logits to return instead of the
    last one: bucketed prefill pads prompts up to a bucket length L and
    passes ``P - 1``; causal masking keeps positions < P from ever
    attending the pad tail, so those logits are the unpadded prompt's.

    ``front_pad``/``num_real`` (both or neither) switch to FRONT-padded
    bucketing for SSM and hybrid configs, whose state scan cannot ride
    the causal mask past a tail pad: the real tokens sit at
    ``[front_pad, front_pad + num_real)``, pads are masked out of the
    attention kv and of the SSD recurrence (``dt = 0`` identity steps),
    RoPE and causal positions shift to ``arange(S) - front_pad``, and the
    K/V lines roll back so the real tokens land at lines ``[0,
    num_real)``.  Callers align ``front_pad`` to a multiple of
    ``cfg.ssm.chunk`` and pass ``last_pos = front_pad + num_real - 1``.
    Needs rotary (not sinusoidal) positions and no sliding-window ring.

    The cache slice holds per sublayer slot ``{"k","v"} (G, B, n, K, Dh)``
    with ``n = S`` lines (``min(cache_len, window)`` ring-placed lines
    under a sliding window; see :func:`models.attention.attention_prefill`)
    or ``{"state" (G, B, H, P, N), "conv" (G, B, W-1, C)}``.
    """
    params = use_params(params, "root")
    h = build_hidden(params, batch, cfg)
    S = h.shape[1]
    cache_len = cache_len or S
    slots = min(cache_len, cfg.sliding_window or cache_len)
    positions = valid = conv_end = None
    if front_pad is not None:
        assert num_real is not None
        assert cfg.pos_embedding != "sinusoidal", \
            "front-padded prefill: sinusoidal PE is applied in " \
            "build_hidden, before the position shift"
        idx = torch.arange(S, device=h.device)
        valid = (idx >= front_pad) & (idx < front_pad + num_real)
        positions = idx - front_pad
        conv_end = front_pad + num_real

    def mix(mixer, p, x, _c):
        if mixer == "attn":
            return A.attention_prefill(p["attn"], x, cfg, slots,
                                       use_kernels=run.use_kernels,
                                       positions=positions, valid=valid,
                                       roll=front_pad)
        return SSM.ssm_prefill(p["ssm"], x, cfg, use_kernels=run.use_kernels,
                               valid=valid, conv_end=conv_end)

    h, per_group = _layers(params, h, cfg, mix, spans=_PREFILL_MIXER_SPAN)
    h = rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    h_last = h[:, -1:] if last_pos is None else h[:, last_pos:last_pos + 1]
    logits = unembed(params, h_last, cfg)
    return logits, {"layers": _stack_caches(per_group)}


def prefill_suffix(params, batch: dict, cache, page_table, start,
                   cfg: ModelConfig, run: RunConfig,
                   last_pos: Optional[int] = None):
    """Prefill the tokens past a prefix already in the paged pool (the
    prefix-cache hit path: only the prompt's un-cached tail runs).

    ``batch["tokens"]``: (B, S) the suffix tokens, at absolute positions
    ``start + [0, S)``; ``cache``: the paged pool (only read here);
    ``page_table``: (B, n) rows whose first ``ceil(start / page_size)``
    entries map the prefix; ``start``: int prefix length — page-aligned on
    the prefix-cache path, anywhere for :func:`prefill_chunk` (the prefix
    mask is line-granular); ``last_pos`` as in :func:`prefill`, a local
    index into the suffix.  The attention is the plain path of
    ``attention.attention_prefill_paged`` whatever ``run.use_kernels``
    says: the JAX version reaches no Pallas kernel either.

    Returns (logits (B,1,V), {"layers": [{"k","v"} (G, B, S, K, Dh)]}):
    the suffix lines, for the caller to write into its own pages; shared
    pages are never written.  Full-attention configs only (paging already
    gates SSM out).
    """
    assert _attn_only(cfg), "prefix reuse is full-attention only"
    params = use_params(params, "root")
    h = add_positions(embed_tokens(params, batch["tokens"], cfg), start, cfg)

    def mix(_mixer, p, x, c):
        return A.attention_prefill_paged(p["attn"], x, c, page_table, start,
                                         cfg)

    h, per_group = _layers(params, h, cfg, mix, cache=cache)
    h = rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    h_last = h[:, -1:] if last_pos is None else h[:, last_pos:last_pos + 1]
    return unembed(params, h_last, cfg), {"layers": _stack_caches(per_group)}


def prefill_chunk(params, batch: dict, cache, page_table, start,
                  cfg: ModelConfig, run: RunConfig,
                  last_pos: Optional[int] = None):
    """One chunk of a chunked (token-budgeted) prefill: chunk ``i`` treats
    the ``start`` lines already in the request's pages as its prefix, so
    it is :func:`prefill_suffix` with a ``start`` that need not be
    page-aligned and rows covering the pages of ``[0, start + S)``.  The
    caller writes the returned lines line by line, mid-page where the
    chunk starts or ends inside a page.  Greedy decode after N chunks
    equals one whole-prompt prefill's: the same masked attention over the
    same absolute positions, with the f32 two-region combine."""
    return prefill_suffix(params, batch, cache, page_table, start, cfg, run,
                          last_pos=last_pos)


# ----------------------------------------------------------------- decode ----

def decode_step(params, cache, token, pos, cfg: ModelConfig, run: RunConfig,
                page_table=None):
    """One decoding step.  token: (B, 1) int; pos: scalar or (B,) int
    (0-based absolute position of each new token).  ``page_table``
    ((B, n_pages) int32) routes attention through the paged KV pool.
    Writes the new KV lines and SSM states into ``cache`` in place;
    returns (logits (B,1,V), cache)."""
    params = use_params(params, "root")
    h = add_positions(embed_tokens(params, token, cfg), pos, cfg)

    def mix(mixer, p, x, c):
        if mixer != "attn":
            return SSM.ssm_decode(p["ssm"], x, c, cfg,
                                  use_kernels=run.use_kernels)
        if page_table is not None:
            return A.attention_decode_paged(p["attn"], x, c, pos, page_table,
                                            cfg, use_kernels=run.use_kernels)
        return A.attention_decode(p["attn"], x, c, pos, cfg,
                                  use_kernels=run.use_kernels)

    h, _ = _layers(params, h, cfg, mix, cache=cache, spans=_MIXER_SPAN)
    h = rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params, h, cfg), cache


def verify_tokens(params, cache, tokens, pos0, pages, offs, page_table,
                  cfg: ModelConfig, run: RunConfig):
    """Score S = k+1 tokens per slot in one call (speculative
    draft-and-verify).

    tokens: (B, S) — ``tokens[:, 0]`` the slot's last sampled token (its
    KV line is written now, where the next decode step would write it),
    ``tokens[:, 1:]`` the k drafts; pos0: (B,) position of ``tokens[:,
    0]``; pages/offs: (B, S) physical write targets of each line (the
    null page past a slot's allocation and for dead slots); page_table as
    in :func:`decode_step`.  ``logits[:, j]`` predicts position ``pos0 +
    j + 1``; row j is the paged decode step at ``pos0 + j``
    (``attention.attention_verify``, plain products whatever
    ``run.use_kernels`` says, as the JAX version reaches no Pallas
    kernel).  Writes the S lines into the pool in place; returns
    (logits (B, S, V), cache).  Full-attention configs only (paging
    already gates SSM out)."""
    assert _attn_only(cfg), "speculative verify is full-attention only"
    params = use_params(params, "root")
    h = add_positions(embed_tokens(params, tokens, cfg), pos0, cfg)

    def mix(_mixer, p, x, c):
        return A.attention_verify(p["attn"], x, c, pos0, pages, offs,
                                  page_table, cfg)

    h, _ = _layers(params, h, cfg, mix, cache=cache)
    h = rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params, h, cfg), cache


# ------------------------------------------------- fused decode fast path ----

def sample_tokens(generator: torch.Generator, logits, temps):
    """Per-slot sampling on the device.  logits: (B, V); temps: (B,) (0 =>
    greedy).  Sampled slots take the Gumbel-max of ``logits / max(t,
    1e-4)`` with noise drawn from ``generator`` — the same distribution as
    the JAX ``categorical``, not the same bits.  The noise is drawn on
    every call, greedy or not, so one generator stream serves a mixed
    batch."""
    greedy = torch.argmax(logits, dim=-1).to(torch.int32)
    t = torch.clamp(temps, min=1e-4)[:, None]
    expo = torch.empty(logits.shape, dtype=torch.float32,
                       device=logits.device).exponential_(generator=generator)
    sampled = torch.argmax(logits.to(torch.float32) / t - torch.log(expo),
                           dim=-1).to(torch.int32)
    return torch.where(temps > 0, sampled, greedy)


def _token_step(params, cache, tok, pos, rem, done, eos, temps, boundary,
                generator, cfg: ModelConfig, run: RunConfig, page_table):
    """One token step of :func:`decode_n`: decode, sample, stop masking.
    Returns ``(emitted, tok, pos, remaining, done)`` after the step."""
    sc = SPANS.get()
    if sc is not None:
        step = sc.begin("token_step", "model", False)
    logits, _ = decode_step(params, cache, tok[:, None], pos, cfg, run,
                            page_table=page_table)
    if sc is not None:
        sample = sc.begin("sample", "model", False)
    nxt = sample_tokens(generator, logits[:, 0], temps)
    live = ~done
    new_pos = torch.where(live, pos + 1, pos)
    new_rem = torch.where(live, rem - 1, rem)
    hit_eos = (eos >= 0) & (nxt == eos)
    done = done | (live & (hit_eos | (new_rem <= 0) | (new_pos >= boundary)))
    out = (torch.where(live, nxt, PAD_TOKEN_ID), torch.where(live, nxt, tok),
           new_pos, new_rem, done)
    if sc is not None:
        sc.end(sample)
        sc.end(step)
    return out


def graph_eligible(device: torch.device, collectives: bool,
                   grad: bool) -> bool:
    """Whether :func:`decode_n` may replay its token step from a CUDA
    graph: lanes on a CUDA device, no collective in reach of the model
    code (``core.actshard.collectives_scoped``: gloo's all-reduces cannot
    be captured), and no autograd."""
    return device.type == "cuda" and not collectives and not grad


def decode_n(params, cache, token, pos, remaining, done, eos, temps,
             generator: torch.Generator, cfg: ModelConfig, run: RunConfig,
             num_tokens: int, cache_len: int, page_table=None, limit=None,
             graphs: Optional["DecodeGraphs"] = None):
    """Generate up to ``num_tokens`` tokens per slot in one call, with
    sampling and stop handling on the device so the host syncs once per
    chunk instead of once per token.

    Stop masking matches the JAX ``decode_n``: a slot finishes on EOS, on
    ``remaining`` hitting 0, or at its boundary (``cache_len - 1``, or
    ``limit - 1`` per slot in paged mode); finished slots emit
    ``PAD_TOKEN_ID``, stop advancing ``pos``/``remaining`` and re-feed
    their frozen (token, pos).

    Args (device tensors, B = num_slots): token (B,) int32 last sampled
    token; pos (B,) int32 position of ``token``; remaining (B,) int32;
    done (B,) bool; eos (B,) int32 (-1 = none); temps (B,) float32;
    generator (advanced in place); page_table (B, n_pages) int32 and
    limit (B,) int32 in paged mode.  ``graphs`` (a :class:`DecodeGraphs`)
    replays the token steps from a CUDA graph where
    :func:`graph_eligible` allows, and counts the steps either way.

    Returns ``(tokens (B, N), cache, token, pos, remaining, done)``; per
    slot the first ``new_pos - old_pos`` tokens are real, the rest pad.
    """
    lanes = (token, pos, remaining, done, eos, temps)
    if graphs is not None and graph_eligible(
            token.device, collectives_scoped(), torch.is_grad_enabled()):
        return graphs.run(params, cache, lanes, generator, cfg, run,
                          num_tokens, cache_len, page_table, limit)
    boundary = (cache_len - 1) if limit is None else (limit - 1)
    tok, rem = token, remaining
    emitted = []
    for _ in range(num_tokens):
        out, tok, pos, rem, done = _token_step(
            params, cache, tok, pos, rem, done, eos, temps, boundary,
            generator, cfg, run, page_table)
        emitted.append(out)
    if graphs is not None:
        graphs.count_eager(num_tokens)
    return torch.stack(emitted, dim=1), cache, tok, pos, rem, done


def _leaf_ptrs(tree) -> tuple:
    """The device addresses of a tree's tensors, in order."""
    if isinstance(tree, dict):
        return tuple(p for v in tree.values() for p in _leaf_ptrs(v))
    if isinstance(tree, (list, tuple)):
        return tuple(p for v in tree for p in _leaf_ptrs(v))
    return (tree.data_ptr(),) if isinstance(tree, torch.Tensor) else ()


class _StaticStep:
    """:func:`decode_n`'s lanes in buffers of their own, and the token step
    that reads them and writes its results back into them (the emitted
    token into ``emitted``): the unit a CUDA graph captures."""

    def __init__(self, params, cache, lanes, generator, cfg, run, cache_len,
                 page_table, limit):
        self.lanes = [torch.empty_like(x) for x in lanes]
        self.table = None if page_table is None \
            else torch.empty_like(page_table)
        self.limit = None if limit is None else torch.empty_like(limit)
        self.emitted = torch.empty(lanes[0].shape, dtype=torch.int32,
                                   device=lanes[0].device)
        self.call = (params, cache, generator, cfg, run, cache_len)
        #: replays the step (set by :meth:`DecodeGraphs._first`; holds
        #: the graph)
        self.replay = None
        #: kernel launches of one step (``kernels.ops.launch_counts``)
        self.launches: dict = {}

    def load(self, lanes, page_table, limit):
        for buf, x in zip(self.lanes, lanes):
            buf.copy_(x)
        if self.table is not None:
            self.table.copy_(page_table)
        if self.limit is not None:
            self.limit.copy_(limit)

    def step(self):
        params, cache, generator, cfg, run, cache_len = self.call
        tok, pos, rem, done, eos, temps = self.lanes
        boundary = (cache_len - 1) if self.limit is None \
            else (self.limit - 1)
        out = _token_step(params, cache, tok, pos, rem, done, eos, temps,
                          boundary, generator, cfg, run, self.table)
        for buf, x in zip((self.emitted, tok, pos, rem, done), out):
            buf.copy_(x)


class DecodeGraphs:
    """One engine's CUDA graphs of :func:`decode_n`'s token step, which
    replace the ~2,300 launches a token step of a full-width model makes
    from Python by one graph launch.

    A graph is keyed by what the call shows: the lanes' shapes and dtypes
    (the batch), the page table's width (None: the dense cache), the
    device, the addresses of the weights and the cache, the generator,
    the config and the dense cache's length.  The first call with a new
    key runs its first token step eagerly on the capture stream, then
    captures the step; every later token step is a replay.  A call
    copies the lanes into the graph's buffers once, replays, copies each
    emitted token into its column, and hands back copies of the lanes.
    The graphs share one memory pool (they never run at once) and are
    freed with the store.  The sampling generator is registered with
    every graph, so that each replay draws new noise, as an eager step
    does; each replay adds its capture's kernel launches to
    ``kernels.ops``' counters.  Counters in ``metrics``: captures,
    replayed token steps, eager token steps."""

    def __init__(self, metrics: Optional[MetricsRegistry] = None):
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._steps: dict = {}
        self._pool = self._stream = None
        #: token steps the last call replayed (0: it ran eagerly)
        self.replayed = 0

    def count_eager(self, n: int):
        self.metrics.counter(METRIC_SERVE_DECODE_EAGER_STEPS,
                             "decode token steps run eagerly").inc(n)
        self.replayed = 0

    def run(self, params, cache, lanes, generator, cfg, run, num_tokens,
            cache_len, page_table, limit):
        """:func:`decode_n` through the graph of its key."""
        token = lanes[0]
        key = (tuple((x.shape, x.dtype) for x in lanes), token.device,
               None if page_table is None else tuple(page_table.shape),
               _leaf_ptrs(params), _leaf_ptrs(cache), id(generator),
               id(cfg), id(run), cache_len if limit is None else None)
        out = torch.empty((token.shape[0], num_tokens), dtype=torch.int32,
                          device=token.device)
        st = self._steps.get(key)
        first = 0
        if st is None:
            st = _StaticStep(params, cache, lanes, generator, cfg, run,
                             cache_len, page_table, limit)
            st.load(lanes, page_table, limit)
            self._first(st)
            self._steps[key] = st
            self.metrics.counter(METRIC_SERVE_DECODE_GRAPH_CAPTURES,
                                 "decode token-step graphs captured").inc()
            self.count_eager(1)
            out[:, 0].copy_(st.emitted)
            first = 1
        else:
            st.load(lanes, page_table, limit)
        for j in range(first, num_tokens):
            st.replay()
            out[:, j].copy_(st.emitted)
        n = num_tokens - first
        kops.add_launch_counts(st.launches, n)
        self.metrics.counter(METRIC_SERVE_DECODE_GRAPH_REPLAYS,
                             "decode token steps replayed").inc(n)
        self.replayed = n
        tok, pos, rem, done = (x.clone() for x in st.lanes[:4])
        return out, cache, tok, pos, rem, done

    def _first(self, st: _StaticStep):
        """Run the key's first token step eagerly on the capture stream
        (it finds ready what a capture needs: the kernel libraries, the
        decode kernels' counters, the products' workspace on that stream),
        then capture the step there, with no span scope."""
        dev = st.emitted.device
        main = torch.cuda.current_stream(dev)
        if self._stream is None:
            self._stream = torch.cuda.Stream(dev)
            self._pool = torch.cuda.graph_pool_handle()
        side = self._stream
        side.wait_stream(main)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(st.call[2])
        tok = SPANS.set(None)
        try:
            with torch.cuda.stream(side):
                st.step()
            before = kops.launch_counts()
            with torch.cuda.graph(graph, pool=self._pool, stream=side,
                                  capture_error_mode="thread_local"):
                st.step()
            after = kops.launch_counts()
        finally:
            SPANS.reset(tok)
        main.wait_stream(side)
        st.launches = {k: after[k] - before[k] for k in after}
        kops.add_launch_counts(st.launches, -1)
        st.replay = graph.replay
