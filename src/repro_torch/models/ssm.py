"""Mamba-2 SSD (state-space duality) block — chunked train/prefill scan and
O(1)-state recurrent decode; the port of the JAX package's
``models/ssm.py``.  [arXiv:2405.21060]

The chunked algorithm (``ssd_chunked``) splits the sequence into chunks of
length Q: within a chunk the dual "attention-like" quadratic form is used,
across chunks a linear recurrence carries the (H, P, N) state.  This plain
PyTorch implementation is the reference path; in training ``use_kernels``
routes the scan through ``kernels.ops.ssd_scan`` (the CUDA kernel on the
card).  Serving prefill reaches no kernel, as in the JAX package: it runs
the plain ``ssd_chunked`` (the cache needs its final state, which the
scan kernel does not return).  Decode is one recurrence step, which
``use_kernels`` runs through the port's decode-step kernel
(``kernels.ops.ssd_decode_step``; the JAX package has none).

Under training tensor parallelism (``core.actshard.tp_train_scope``) a
rank whose plan shards the SSD heads runs its ``H/m`` heads: its columns
of ``wz``/``wx``/``wdt``, all of ``B``/``C`` and the conv channels of
both, a partial output projection and a gated norm whose sum of squares
is summed over the ranks.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.core.actshard import (
    tp_enter, tp_exit, tp_gather, tp_sum, tp_train,
)
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.models.init import torch_dtype

f32 = torch.float32


def _rmsnorm_gated(y, z, scale, eps, width: Optional[int] = None):
    """``width``: the whole inner dim, of which ``y`` holds this rank's
    columns; the mean square is then the ranks' summed squares over it."""
    y = y * F.silu(z.to(f32)).to(y.dtype)
    if width is None:
        var = torch.mean(torch.square(y.to(f32)), dim=-1, keepdim=True)
    else:
        var = tp_sum(torch.sum(torch.square(y.to(f32)), dim=-1,
                               keepdim=True)) / width
    y = y.to(f32) * torch.rsqrt(var + eps)
    return (y * scale.to(f32)).to(z.dtype)


def _causal_conv(u: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 init_state: Optional[torch.Tensor] = None):
    """Depthwise causal conv1d.  u: (B,S,C), w: (W,C), b: (C,).

    Returns (y (B,S,C), new_state (B,W-1,C)) — state = last W-1 inputs.
    """
    W = w.shape[0]
    S = u.shape[1]
    if init_state is None:
        pad = torch.zeros((u.shape[0], W - 1, u.shape[2]), dtype=u.dtype,
                          device=u.device)
    else:
        pad = init_state.to(u.dtype)
    up = torch.cat([pad, u], dim=1)                     # (B, S+W-1, C)
    y = torch.zeros_like(u)
    for i in range(W):
        y = y + up[:, i:i + S] * w[i].to(u.dtype)
    y = y + b.to(u.dtype)
    new_state = up[:, up.shape[1] - (W - 1):]
    return y, new_state


def ssd_chunked(x, dt, A, Bm, Cm, chunk: int, init_state=None):
    """Chunked SSD scan.

    x: (B,S,H,P) head inputs; dt: (B,S,H) post-softplus steps; A: (H,) < 0;
    Bm/Cm: (B,S,N) input/output projections (shared across heads, 1 group).
    Returns (y (B,S,H,P), final_state (B,H,P,N)).  The chunked algorithm is
    the kernel's plain version (``kernels.ref.ssd_chunks``); this route
    adds what the JAX model's scan does around it: x dt rounded to x's
    dtype, a ragged S and an initial state.
    """
    S = x.shape[1]
    if S % chunk:
        # pad with dt=0 tokens: decay exp(0)=1, zero input — identity for the
        # recurrence, so the final state is exact; padded outputs are sliced.
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    dtf = dt.to(f32)
    xdt = (x.to(f32) * dtf[..., None]).to(x.dtype).to(f32)
    y, s = kref.ssd_chunks(xdt, dtf * A.to(f32), Bm, Cm, chunk, init_state)
    return y[:, :S].to(x.dtype), s


def _proj_split(p: dict, x: torch.Tensor, cfg: ModelConfig):
    """Project residual stream to (z, conv-input u=[xin,B,C], dt_raw)."""
    dtype = x.dtype
    z = x @ p["wz"].to(dtype)
    xin = x @ p["wx"].to(dtype)
    Bm = x @ p["wB"].to(dtype)
    Cm = x @ p["wC"].to(dtype)
    dt_raw = x @ p["wdt"].to(dtype)
    u = torch.cat([xin, Bm, Cm], dim=-1)
    return z, u, dt_raw


def _post_conv_split(u, cfg: ModelConfig, di: Optional[int] = None):
    """(xin, B, C) of the conv output; ``di``: the width of ``xin`` in
    ``u`` (default the whole inner dim)."""
    di = cfg.ssm.d_inner(cfg.d_model) if di is None else di
    N = cfg.ssm.state
    return u[..., :di], u[..., di:di + N], u[..., di + N:]


def _rank_block(p: dict, cfg: ModelConfig):
    """The block as this rank runs it under a training TP plan (none:
    as it is): ``(p, channels, di)``.  Where the plan shards the inner
    dim but not the heads, the inner-dim weights are gathered and the
    block runs whole; where it shards the heads, ``channels`` indexes the
    rank's conv channels — its ``xin`` columns and every ``B`` and ``C``
    channel, the conv's channels being ``[xin, B, C]`` — and ``di`` is
    its share of the inner dim."""
    plan = tp_train()
    ssm = cfg.ssm
    if plan is not None and plan.ssm_inner and not plan.ssm:
        p = dict(p, wz=tp_gather(p["wz"], 1), wx=tp_gather(p["wx"], 1),
                 norm_scale=tp_gather(p["norm_scale"], 0),
                 wo=tp_gather(p["wo"], 0))
    di = p["A_log"].shape[0] * ssm.head_dim       # this rank's heads
    channels = None
    if plan is not None and plan.ssm:
        whole = ssm.d_inner(cfg.d_model)
        channels = torch.cat([
            torch.arange(plan.index * di, (plan.index + 1) * di),
            torch.arange(whole, whole + 2 * ssm.state)]).to(
                p["conv_w"].device)
    return p, channels, di


def _rank_conv(p: dict, channels):
    """The conv weights of this rank's channels (all of them: None)."""
    if channels is None:
        return p["conv_w"], p["conv_b"]
    return (p["conv_w"].index_select(1, channels),
            p["conv_b"].index_select(0, channels))


def _whole_channels(u: torch.Tensor, di: int) -> torch.Tensor:
    """Conv inputs ``[xin, B, C]`` of this rank's ``xin`` columns -> every
    rank's, the ``xin`` part all-gathered over the ranks (the decode
    cache holds the conv window whole on every rank)."""
    return torch.cat([tp_gather(u[..., :di], u.ndim - 1), u[..., di:]],
                     dim=-1)


def ssm_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
              use_kernels: bool = False) -> torch.Tensor:
    """(B,S,d) -> (B,S,d), full-sequence (training core).  Under a
    training TP plan that shards the inner dim the block runs between
    points (``core.actshard.tp_enter``/``tp_exit``): on its ``H/m`` heads
    where the heads shard; whole, from the gathered inner-dim weights,
    where they do not (a rank's columns would not fall on whole heads)."""
    plan = tp_train()
    points = plan is not None and (plan.ssm_inner or plan.seq)
    if points:
        x = tp_enter(x)
    p, channels, di = _rank_block(p, cfg)
    sharded = channels is not None
    B, S, _ = x.shape
    ssm = cfg.ssm
    H = p["A_log"].shape[0]                  # this rank's heads
    P = ssm.head_dim
    conv_w, conv_b = _rank_conv(p, channels)
    z, u, dt_raw = _proj_split(p, x, cfg)
    u, _ = _causal_conv(u, conv_w, conv_b)
    u = F.silu(u)
    xin, Bm, Cm = _post_conv_split(u, cfg, di)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    xh = xin.reshape(B, S, H, P)
    if use_kernels:
        y = kops.ssd_scan(xh, dt, A, Bm, Cm, chunk=ssm.chunk)
    else:
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, H * P)
    y = _rmsnorm_gated(y, z, p["norm_scale"], cfg.norm_eps,
                       width=ssm.d_inner(cfg.d_model) if sharded else None)
    out = y @ p["wo"].to(y.dtype)
    return tp_exit(out, partial=sharded) if points else out


def init_ssm_cache(cfg: ModelConfig, batch: int, n_groups: int,
                   dtype=torch.float32, device=None):
    """Stacked SSD decode state for one ssm sublayer slot: ``state`` (G, B,
    H, P, N) in ``dtype`` (f32) and ``conv`` (G, B, W-1, C) in
    ``cfg.dtype``, the last W-1 conv inputs."""
    ssm = cfg.ssm
    H = ssm.num_heads(cfg.d_model)
    conv_ch = ssm.d_inner(cfg.d_model) + 2 * ssm.state
    return {"state": torch.zeros((n_groups, batch, H, ssm.head_dim,
                                  ssm.state), dtype=dtype, device=device),
            "conv": torch.zeros((n_groups, batch, ssm.conv_width - 1,
                                 conv_ch), dtype=torch_dtype(cfg.dtype),
                                device=device)}


def ssm_prefill(p: dict, x: torch.Tensor, cfg: ModelConfig,
                use_kernels: bool = False, valid=None, conv_end=None):
    """Full-sequence forward that also returns the decode cache.

    ``use_kernels`` is taken and ignored, as the JAX ``use_pallas`` is
    here: the cache needs the scan's final state, so the plain
    :func:`ssd_chunked` runs.

    ``valid`` ((S,) bool, optional) marks pad positions of a front-padded
    bucketed prompt.  ``dt = softplus(dt_raw + dt_bias)`` is nonzero even
    for zero input, so pads are masked at the two recurrence inputs: the
    conv input ``u`` (pads give the zeros the unpadded run's conv
    init-state gives) and ``dt`` (``dt = 0`` makes a pad an identity step
    of the scan).  The caller aligns the front pad to a chunk boundary, so
    the real tokens' chunk offsets match the unpadded run.

    ``conv_end`` (int, optional: ``front_pad + num_real``) ends the conv
    window at the last real token instead of the padded tail.

    Under a training TP plan (the serve step's) the block runs as
    :func:`ssm_train` runs it — on this rank's heads, ``state`` holding
    them, the output summed over the ranks — and ``conv`` holds every
    channel, as the decode cache does.

    Returns (out (B,S,d), {"state" (B,H,P,N) f32, "conv" (B,W-1,C)})."""
    plan = tp_train()
    points = plan is not None and plan.ssm_inner
    if points:
        x = tp_enter(x)
    p, channels, di = _rank_block(p, cfg)
    B, S, _ = x.shape
    ssm = cfg.ssm
    H, P = p["A_log"].shape[0], ssm.head_dim
    z, u, dt_raw = _proj_split(p, x, cfg)
    if valid is not None:
        u = u * valid[None, :, None].to(u.dtype)
    conv_w, conv_b = _rank_conv(p, channels)
    u_conv, conv_state = _causal_conv(u, conv_w, conv_b)
    u_conv = F.silu(u_conv)
    xin, Bm, Cm = _post_conv_split(u_conv, cfg, di)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    if valid is not None:
        dt = dt * valid[None, :, None].to(dt.dtype)
    A = -torch.exp(p["A_log"].to(f32))
    xh = xin.reshape(B, S, H, P)
    y, state = ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, H * P)
    sharded = channels is not None
    y = _rmsnorm_gated(y, z, p["norm_scale"], cfg.norm_eps,
                       width=ssm.d_inner(cfg.d_model) if sharded else None)
    out = y @ p["wo"].to(y.dtype)
    if conv_end is not None:
        # window of W-1 inputs ending at the last real token; when the
        # prompt is shorter than the window it slides into the masked
        # front pad, whose zeros match the unpadded run's zero init-state
        W = p["conv_w"].shape[0]
        up = torch.cat([torch.zeros((B, W - 1, u.shape[-1]), dtype=u.dtype,
                                    device=u.device), u], dim=1)
        conv_state = up[:, conv_end:conv_end + W - 1]
    if sharded:
        conv_state = _whole_channels(conv_state, di)
    if points:
        out = tp_exit(out, partial=sharded)
    return out, {"state": state,
                 "conv": conv_state.to(torch_dtype(cfg.dtype))}


def ssm_decode(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
               use_kernels: bool = False):
    """One-token recurrent decode.  x: (B,1,d); cache: this group's
    ``state`` (B,H,P,N) and ``conv`` (B,W-1,C), updated **in place**
    as the attention decode writes its KV line.  ``use_kernels`` runs
    the recurrence's step through ``kernels.ops.ssd_decode_step`` (the
    CUDA kernel on the card, which reads and writes the state once);
    otherwise its plain version.  Under a
    training TP plan (the serve step's) the block runs on this rank's
    heads, as :func:`ssm_prefill` does: ``state`` holds them, ``conv``
    every channel (the step's ``xin`` columns all-gathered).  Returns
    (out (B,1,d), cache)."""
    plan = tp_train()
    points = plan is not None and plan.ssm_inner
    if points:
        x = tp_enter(x)
    p, channels, di = _rank_block(p, cfg)
    B = x.shape[0]
    ssm = cfg.ssm
    H, P = p["A_log"].shape[0], ssm.head_dim
    z, u, dt_raw = _proj_split(p, x, cfg)                 # (B,1,*)
    sharded = channels is not None
    # conv: window = [conv_state, u_t], every channel
    win = torch.cat([cache["conv"].to(u.dtype),
                     _whole_channels(u, di) if sharded else u], dim=1)
    conv_w, conv_b = _rank_conv(p, channels)
    mine = win if channels is None else win.index_select(2, channels)
    y_conv = torch.einsum("bwc,wc->bc", mine, conv_w.to(u.dtype))
    y_conv = F.silu(y_conv + conv_b.to(u.dtype))         # (B,C)
    xin, Bm, Cm = _post_conv_split(y_conv, cfg, di)       # (B,*)
    dt = F.softplus(dt_raw[:, 0].to(f32) + p["dt_bias"].to(f32))   # (B,H)
    A = -torch.exp(p["A_log"].to(f32))
    step = kops.ssd_decode_step if use_kernels else kref.ssd_decode_step_ref
    y = step(cache["state"], xin.reshape(B, H, P), dt, A,
             p["D"].to(f32), Bm, Cm)                      # (B,H,P)
    y = y.reshape(B, 1, H * P).to(x.dtype)
    y = _rmsnorm_gated(y, z, p["norm_scale"], cfg.norm_eps,
                       width=ssm.d_inner(cfg.d_model) if sharded else None)
    out = y @ p["wo"].to(y.dtype)
    if points:
        out = tp_exit(out, partial=sharded)
    cache["conv"].copy_(win[:, 1:])
    return out, cache
