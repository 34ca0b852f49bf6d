"""Wrapper of the CUDA causal flash-attention kernel
(``csrc/flash_attention.cu``).

Replaces the TPU kernel ``flash_attention_bhsd`` of the JAX package
(``repro/kernels/flash_attention.py``).  On the card it is bound by
operations at prefill lengths.  One block owns one (batch, q head, q
tile) and loops over kv tiles only up to the causal / window limit, with
an f32 online softmax on chip: in bfloat16 both products run on tensor
cores (``mma.sync``) from 16-byte copies, in float32 on plain FMAs; the
source describes both.  The kernel reads the model layout
``(B, S, H, Dh)`` through strides, so no transpose is materialised.

This module never imports at load time anything that needs ``nvcc``: the
library builds at the first launch.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import logits_scale

_DTYPES = (torch.float32, torch.bfloat16)


def _check(q, k, v):
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda":
            raise ValueError(f"flash_attention: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors")
        if t.dtype not in _DTYPES:
            raise TypeError(f"flash_attention: {name} has dtype {t.dtype}, "
                            "the kernel takes float32 or bfloat16")
        if t.dim() != 4:
            raise ValueError(f"flash_attention: {name} must be (B, S, heads,"
                             f" Dh), got {tuple(t.shape)}")
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs unit stride on "
                             "its last (head_dim) axis")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError("flash_attention: q, k, v must share one dtype")
    if not (q.device == k.device == v.device):
        raise ValueError("flash_attention: q, k, v on different devices")
    B, S, H, Dh = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[1] != S \
            or k.shape[3] != Dh:
        raise ValueError(f"flash_attention: k/v {tuple(k.shape)} do not "
                         f"match q {tuple(q.shape)}")
    K = k.shape[2]
    if H % K:
        raise ValueError(f"flash_attention: {H} q heads not a multiple of "
                         f"{K} kv heads")
    if not 1 <= Dh <= 128:
        raise ValueError(f"flash_attention: head_dim {Dh} outside 1..128")
    if q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            build.check_aligned("flash_attention", name, t)


def attention_args(q, k, v, o, window, stream, scale=None):
    """The argument list of ``repro_flash_attention``
    (``build.SIGNATURES``) for the tensors of a call (``scale``: the
    logits' scale, None for ``Dh ** -0.5``)."""
    B, S, H, Dh = q.shape
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            build.DTYPE_CODES[str(q.dtype).removeprefix("torch.")],
            B, S, H, k.shape[2], Dh, int(window or 0),
            q.stride(0), q.stride(1), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(1), o.stride(2),
            logits_scale(Dh, scale), stream)


def flash_attention_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         window=None, scale=None) -> torch.Tensor:
    """Causal (optionally sliding-window) attention on the card.

    q: (B, S, H, Dh); k/v: (B, S, K, Dh) with H % K == 0; float32 or
    bfloat16; any strides with a unit last stride (in bfloat16, base
    pointers and strides in multiples of 16 bytes).  Returns a new
    contiguous (B, S, H, Dh) tensor of q's dtype, f32 softmax inside of
    the logits times ``scale`` (None: ``Dh ** -0.5``)."""
    _check(q, k, v)
    o = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    build.launch("flash_attention", q.device, lambda stream: attention_args(
        q, k, v, o, window, stream, scale))
    return o
