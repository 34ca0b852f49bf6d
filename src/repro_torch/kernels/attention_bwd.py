"""Wrapper of the CUDA backward of causal attention
(``csrc/attention_bwd.cu``).

The port's own kernel: the TPU kernel ``flash_attention_bhsd`` of the JAX
package is forward-only.  It computes dq, dk and dv of
``flash_attention.flash_attention_bshd`` in bfloat16, in three launches
(a pre-pass writing each row's log-sum-exp and D = dO . O in f32, then
dK/dV a kv tile a block, then dQ a q tile a block) with no atomics, so
its gradients are the same bits from run to run.  On the card it is
bound by operations at training lengths: all five products run on tensor
cores (``mma.sync`` bf16, f32 accumulators), P and dS as two bf16 terms
each, so they keep 16 bits as the plain f32 path does; the source
describes the design.  It reads the model layout ``(B, S, H, Dh)``
through strides, so no transpose is materialised.

This module never imports at load time anything that needs ``nvcc``: the
library builds at the first launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import logits_scale

#: wrapper calls since the last reset (each launches three kernels)
launches = 0


def _check(q, k, v, do):
    for name, t in (("q", q), ("k", k), ("v", v), ("do", do)):
        if t.device.type != "cuda":
            raise ValueError(f"attention_bwd: {name} is on {t.device}, the "
                             "kernel takes CUDA tensors")
        if t.dtype != torch.bfloat16:
            raise TypeError(f"attention_bwd: {name} has dtype {t.dtype}, "
                            "the kernel takes bfloat16")
        if t.dim() != 4:
            raise ValueError(f"attention_bwd: {name} must be (B, S, heads, "
                             f"Dh), got {tuple(t.shape)}")
    if len({t.device for t in (q, k, v, do)}) != 1:
        raise ValueError("attention_bwd: q, k, v, do on different devices")
    B, S, H, Dh = q.shape
    if do.shape != q.shape:
        raise ValueError(f"attention_bwd: do {tuple(do.shape)} does not "
                         f"match q {tuple(q.shape)}")
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != Dh:
        raise ValueError(f"attention_bwd: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    if H % k.shape[2]:
        raise ValueError(f"attention_bwd: {H} q heads not a multiple of "
                         f"{k.shape[2]} kv heads")
    if not 1 <= Dh <= 128:
        raise ValueError(f"attention_bwd: head_dim {Dh} outside 1..128")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"attention_bwd: {name} needs unit stride on "
                             "its last (head_dim) axis")
        build.check_aligned("attention_bwd", name, t)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself if the kernel's 16-byte copies can read it, else a
    copy in storage whose last axis is padded to 16 bytes."""
    if t.stride(-1) == 1 and build.aligned(t):
        return t
    width = -(-t.shape[-1] // 8) * 8
    buf = t.new_zeros(*t.shape[:-1], width)
    buf[..., :t.shape[-1]] = t
    return buf[..., :t.shape[-1]]


def bwd_args(q, k, v, do, dq, dk, dv, lse, delta, window, stream,
             scale=None):
    """The argument list of ``repro_attention_bwd`` (``build.SIGNATURES``)
    for the tensors of a call (``lse``, ``delta``: (B, H, S) float32
    scratch; ``scale``: the logits' scale, None for ``Dh ** -0.5``)."""
    B, S, H, Dh = q.shape
    strides = [t.stride(i) for t in (q, k, v, do, dq, dk, dv)
               for i in range(3)]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), B, S, H, k.shape[2], Dh, int(window or 0),
            *strides, logits_scale(Dh, scale), stream)


def attention_bwd_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       do: torch.Tensor, window=None, scale=None) -> tuple:
    """dq, dk, dv of causal (optionally sliding-window) attention on the
    card, given the output's gradient ``do``.

    q, do: (B, S, H, Dh); k/v: (B, S, K, Dh) with H % K == 0; bfloat16;
    q, k, v with a unit last stride, base pointers and strides in
    multiples of 16 bytes (as the forward kernel takes them).  Returns new
    contiguous tensors of the inputs' shapes, bfloat16."""
    global launches
    _check(q, k, v, do)
    do = _aligned(do)
    B, S, H, _ = q.shape
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    lse, delta = torch.empty((2, B, H, S), dtype=torch.float32,
                             device=q.device)
    lib = build.library("attention_bwd")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_attention_bwd(*bwd_args(
            q, k, v, do, dq, dk, dv, lse, delta, window, stream, scale))
    build.check(err, "attention_bwd")
    launches += 1
    return dq, dk, dv
