"""Mamba-2 SSD (state-space duality) block, training path — the port of
the JAX package's ``models/ssm.py`` up to ``ssm_train``.  [arXiv:2405.21060]

The chunked algorithm (``ssd_chunked``) splits the sequence into chunks of
length Q: within a chunk the dual "attention-like" quadratic form is used,
across chunks a linear recurrence carries the (H, P, N) state.  This plain
PyTorch implementation is the reference path; ``use_kernels`` routes the
scan through ``kernels.ops.ssd_scan`` (the CUDA kernel on the card).  The
serving half (``ssm_prefill``, ``ssm_decode``, ``init_ssm_cache``) comes
with the SSM-serving slice.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref

f32 = torch.float32


def _rmsnorm_gated(y, z, scale, eps):
    y = y * F.silu(z.to(f32)).to(y.dtype)
    var = torch.mean(torch.square(y.to(f32)), dim=-1, keepdim=True)
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


def _post_conv_split(u, cfg: ModelConfig):
    di = cfg.ssm.d_inner(cfg.d_model)
    N = cfg.ssm.state
    return u[..., :di], u[..., di:di + N], u[..., di + N:]


def ssm_train(p: dict, x: torch.Tensor, cfg: ModelConfig,
              use_kernels: bool = False) -> torch.Tensor:
    """(B,S,d) -> (B,S,d), full-sequence (training core)."""
    B, S, _ = x.shape
    ssm = cfg.ssm
    H = ssm.num_heads(cfg.d_model)
    P = ssm.head_dim
    z, u, dt_raw = _proj_split(p, x, cfg)
    u, _ = _causal_conv(u, p["conv_w"], p["conv_b"])
    u = F.silu(u)
    xin, Bm, Cm = _post_conv_split(u, cfg)
    dt = F.softplus(dt_raw.to(f32) + p["dt_bias"].to(f32))
    A = -torch.exp(p["A_log"].to(f32))
    xh = xin.reshape(B, S, H, P)
    if use_kernels:
        y = kops.ssd_scan(xh, dt, A, Bm, Cm, chunk=ssm.chunk)
    else:
        y, _ = ssd_chunked(xh, dt, A, Bm, Cm, ssm.chunk)
    y = y + xh * p["D"].to(y.dtype)[None, None, :, None]
    y = y.reshape(B, S, H * P)
    y = _rmsnorm_gated(y, z, p["norm_scale"], cfg.norm_eps)
    return y @ p["wo"].to(y.dtype)
