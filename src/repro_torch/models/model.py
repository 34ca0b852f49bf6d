"""Model assembly: embedding -> layer groups -> LM head — the port of the
JAX package's ``models/model.py`` for training (dense attention and SSM
configs) and for serving (dense attention configs).

Entry points (plain functions of (params, inputs, cache)):
  * ``forward_train(params, batch, cfg, run)``  -> (logits, aux)
  * ``loss_fn(params, batch, cfg, run)``        -> (loss, metrics)
  * ``prefill(params, batch, cfg, run)``        -> (logits, cache slice)
  * ``decode_step(params, cache, token, pos, cfg, run)`` -> (logits, cache)
  * ``decode_n(params, cache, token, pos, ...)`` -> N tokens per call with
    on-device sampling and per-slot stop masking (one host sync per chunk)

Parameters are the JAX package's tree: layer groups stacked on dim 0 with
period ``group_period(cfg)``; a Python loop over groups replaces
``lax.scan``; under ``run.remat`` ("layer" or "full") each group runs
inside ``torch.utils.checkpoint`` as the JAX scan body runs inside
``jax.checkpoint``.  Decode updates the KV cache in place.
``run.use_kernels`` routes attention and the SSD scan through the CUDA
kernels (``kernels.ops``).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig, RunConfig
from repro_torch.models import attention as A
from repro_torch.models import ssm as SSM
from repro_torch.models.init import torch_dtype
from repro_torch.models.mlp import mlp_apply, rmsnorm
from repro_torch.models.spec import group_period, layer_schedule

#: token emitted by finished slots inside a decode_n chunk (host drops them)
PAD_TOKEN_ID = 0
AUX_KEYS = ("moe_balance_loss", "moe_z_loss")


def compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch_dtype(cfg.dtype)


def _check_dense(cfg: ModelConfig):
    if any(mixer != "attn" or ffn != "dense"
           for mixer, ffn in layer_schedule(cfg)):
        raise NotImplementedError(
            f"{cfg.name}: the port runs dense attention configs; SSM, "
            "hybrid and MoE layers come with a later slice")


def _take(tree, g: int):
    """The group-``g`` slice of a stacked parameter or cache tree (views)."""
    if isinstance(tree, dict):
        return {k: _take(v, g) for k, v in tree.items()}
    return tree[g]


def _groups(params) -> int:
    leaf = params["layers"][0]["norm1"]["scale"]
    return leaf.shape[0]


# ------------------------------------------------------------ embeddings ----

def embed_tokens(params, tokens, cfg: ModelConfig):
    tab = params["embed"]["tok"].to(compute_dtype(cfg))
    return tab[tokens]


def build_hidden(params, batch: dict, cfg: ModelConfig):
    """Input hidden states from tokens (+ sinusoidal PE for configs that
    use it).  The modality stubs of the JAX version wait for their
    families."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the {cfg.frontend} frontend stub comes with the "
            "VLM/audio slice (ROADMAP A3)")
    h = embed_tokens(params, batch["tokens"], cfg)
    if cfg.pos_embedding == "sinusoidal":
        S = h.shape[1]
        pe = A.sinusoidal_pe(torch.arange(S, device=h.device), cfg.d_model)
        h = h + pe.to(h.dtype)[None]
    return h


def unembed(params, h, cfg: ModelConfig):
    w = params["embed"]["tok"] if cfg.tie_embeddings else params["lm_head"]["w"]
    return torch.einsum("bsd,vd->bsv", h, w.to(h.dtype))


# -------------------------------------------------------------- training ----

def _zeros_aux(device):
    return {k: torch.zeros((), dtype=torch.float32, device=device)
            for k in AUX_KEYS}


def sublayer_train(p, x, mixer: str, ffn: str, cfg: ModelConfig,
                   run: RunConfig):
    aux = _zeros_aux(x.device)
    h = rmsnorm(x, p["norm1"]["scale"], cfg.norm_eps)
    if mixer == "attn":
        h = A.attention_train(p["attn"], h, cfg, use_kernels=run.use_kernels)
    else:
        h = SSM.ssm_train(p["ssm"], h, cfg, use_kernels=run.use_kernels)
    x = x + h
    if ffn == "moe":
        raise NotImplementedError(
            f"{cfg.name}: MoE layers come with the MoE slice (ROADMAP A3)")
    if ffn != "none":
        h = rmsnorm(x, p["norm2"]["scale"], cfg.norm_eps)
        x = x + mlp_apply(p["mlp"], h, cfg.mlp_type)
    return x, aux


def backbone_train(params, h, cfg: ModelConfig, run: RunConfig):
    """The layer groups in a Python loop; returns (h, aux sums).  Under
    ``run.remat`` in ("layer", "full") each group is recomputed in the
    backward pass instead of keeping its activations."""
    P = group_period(cfg)
    sched = layer_schedule(cfg)[:P]

    def group_body(x, group_params):
        acc = _zeros_aux(x.device)
        for i, (mixer, ffn) in enumerate(sched):
            x, aux = sublayer_train(group_params[i], x, mixer, ffn, cfg, run)
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
    h = build_hidden(params, batch, cfg)
    h, aux = backbone_train(params, h, cfg, run)
    h = rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    return unembed(params, h, cfg), aux


def softmax_xent(logits, labels, mask):
    """Mean cross entropy over the tokens where ``mask`` is set, in f32
    (the JAX one-hot sum, written as a gather)."""
    lg = logits.to(torch.float32)
    lse = torch.logsumexp(lg, dim=-1)
    ll = torch.gather(lg, -1, labels.to(torch.int64)[..., None])[..., 0]
    per_tok = (lse - ll) * mask
    return torch.sum(per_tok) / torch.clamp(torch.sum(mask), min=1.0)


def loss_fn(params, batch: dict, cfg: ModelConfig, run: RunConfig):
    logits, aux = forward_train(params, batch, cfg, run)
    mask = batch.get("loss_mask")
    if mask is None:
        mask = torch.ones(batch["labels"].shape, dtype=torch.float32,
                          device=logits.device)
    xent = softmax_xent(logits, batch["labels"], mask)
    metrics = {"loss": xent, "xent": xent, **aux}
    return xent, metrics


# ----------------------------------------------------------------- cache ----

def init_cache(cfg: ModelConfig, batch: int, cache_len: int, device=None,
               paging=None):
    """Decode cache: one entry per sublayer slot, stacked over groups.
    ``paging`` makes every attention sublayer a shared page pool."""
    _check_dense(cfg)
    P = group_period(cfg)
    n_groups = cfg.num_layers // P
    return {"layers": [A.init_kv_cache(cfg, batch, cache_len, n_groups,
                                       device=device, paging=paging)
                       for _ in range(P)]}


# --------------------------------------------------------------- prefill ----

def _ffn(p, x, cfg: ModelConfig):
    hh = rmsnorm(x, p["norm2"]["scale"], cfg.norm_eps)
    return x + mlp_apply(p["mlp"], hh, cfg.mlp_type)


def prefill(params, batch: dict, cfg: ModelConfig, run: RunConfig,
            cache_len: Optional[int] = None,
            last_pos: Optional[int] = None):
    """Run the full prompt, return (logits (B,1,V), cache slice).

    ``last_pos`` selects which position's logits to return instead of the
    last one: bucketed prefill pads prompts up to a bucket length L and
    passes ``P - 1``; causal masking keeps positions < P from ever
    attending the pad tail, so those logits are the unpadded prompt's.

    The cache slice is ``{"layers": [{"k","v"} (G, B, n, K, Dh)]}`` with
    ``n = S`` lines (``min(cache_len, window)`` ring-placed lines under a
    sliding window); see :func:`models.attention.attention_prefill`.
    """
    _check_dense(cfg)
    P = group_period(cfg)
    h = build_hidden(params, batch, cfg)
    S = h.shape[1]
    cache_len = cache_len or S
    slots = min(cache_len, cfg.sliding_window or cache_len)
    per_layer = [{"k": [], "v": []} for _ in range(P)]
    for g in range(_groups(params)):
        for i in range(P):
            p = _take(params["layers"][i], g)
            hh = rmsnorm(h, p["norm1"]["scale"], cfg.norm_eps)
            hh, c = A.attention_prefill(p["attn"], hh, cfg, slots,
                                        use_kernels=run.use_kernels)
            h = _ffn(p, h + hh, cfg)
            per_layer[i]["k"].append(c["k"])
            per_layer[i]["v"].append(c["v"])
    h = rmsnorm(h, params["final_norm"]["scale"], cfg.norm_eps)
    h_last = h[:, -1:] if last_pos is None else h[:, last_pos:last_pos + 1]
    logits = unembed(params, h_last, cfg)
    caches = [{"k": torch.stack(c["k"]), "v": torch.stack(c["v"])}
              for c in per_layer]
    return logits, {"layers": caches}


# ----------------------------------------------------------------- decode ----

def decode_step(params, cache, token, pos, cfg: ModelConfig, run: RunConfig,
                page_table=None):
    """One decoding step.  token: (B, 1) int; pos: scalar or (B,) int
    (0-based absolute position of each new token).  ``page_table``
    ((B, n_pages) int32) routes attention through the paged KV pool.
    Writes the new KV lines into ``cache`` in place; returns
    (logits (B,1,V), cache)."""
    P = group_period(cfg)
    B = token.shape[0]
    h = embed_tokens(params, token, cfg)
    if cfg.pos_embedding == "sinusoidal":
        posv = torch.broadcast_to(torch.as_tensor(pos, device=h.device), (B,))
        pe = A.sinusoidal_pe(posv[:, None], cfg.d_model)   # (B,1,d)
        h = h + pe.to(h.dtype)
    for g in range(_groups(params)):
        for i in range(P):
            p = _take(params["layers"][i], g)
            c = _take(cache["layers"][i], g)
            hh = rmsnorm(h, p["norm1"]["scale"], cfg.norm_eps)
            if page_table is not None:
                hh, _ = A.attention_decode_paged(
                    p["attn"], hh, c, pos, page_table, cfg,
                    use_kernels=run.use_kernels)
            else:
                hh, _ = A.attention_decode(p["attn"], hh, c, pos, cfg,
                                           use_kernels=run.use_kernels)
            h = _ffn(p, h + hh, cfg)
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


def decode_n(params, cache, token, pos, remaining, done, eos, temps,
             generator: torch.Generator, cfg: ModelConfig, run: RunConfig,
             num_tokens: int, cache_len: int, page_table=None, limit=None):
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
    limit (B,) int32 in paged mode.

    Returns ``(tokens (B, N), cache, token, pos, remaining, done)``; per
    slot the first ``new_pos - old_pos`` tokens are real, the rest pad.
    """
    boundary = (cache_len - 1) if limit is None else (limit - 1)
    tok, rem = token, remaining
    emitted = []
    for _ in range(num_tokens):
        logits, cache = decode_step(params, cache, tok[:, None], pos, cfg,
                                    run, page_table=page_table)
        nxt = sample_tokens(generator, logits[:, 0], temps)
        live = ~done
        emitted.append(torch.where(live, nxt, PAD_TOKEN_ID))
        new_pos = torch.where(live, pos + 1, pos)
        new_rem = torch.where(live, rem - 1, rem)
        hit_eos = (eos >= 0) & (nxt == eos)
        done = done | (live & (hit_eos | (new_rem <= 0)
                               | (new_pos >= boundary)))
        tok = torch.where(live, nxt, tok)
        pos, rem = new_pos, new_rem
    return torch.stack(emitted, dim=1), cache, tok, pos, rem, done
