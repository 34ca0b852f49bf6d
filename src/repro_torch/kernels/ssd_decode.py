"""Wrapper of the CUDA Mamba-2 SSD decode-step kernel
(``csrc/ssd_decode.cu``): one token of the recurrence for every sequence
of a batch, the (B, H, P, N) f32 state updated in place.

The JAX package has no kernel here (its decode step is plain jnp); the
serving decode of a state-space model reaches this one kernel per SSM
layer and token.  It is bound by bytes: it reads the state once and
writes it once, where the plain step (``kernels.ref.ssd_decode_step_ref``)
makes several f32 passes over it.  The source describes the design.

The library builds at the first launch, never at import.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

_DTYPES = (torch.float32, torch.bfloat16)
#: the largest state size: a row of N / 4 float4s is at most one warp
MAX_STATE = 128


def _check(state, x, dt, A, D, Bm, Cm):
    for name, t in (("state", state), ("x", x), ("dt", dt), ("A", A),
                    ("D", D), ("Bm", Bm), ("Cm", Cm)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_decode_step: {name} is on {t.device}, "
                             "the kernel takes CUDA tensors")
        if t.device != state.device:
            raise ValueError(f"ssd_decode_step: {name} is not on the "
                             "state's device")
    if state.dtype != torch.float32 or state.dim() != 4 or \
            not state.is_contiguous():
        raise ValueError("ssd_decode_step: state must be a contiguous "
                         "(B, H, P, N) float32 tensor, got "
                         f"{state.dtype} {tuple(state.shape)}")
    B, H, P, N = state.shape
    if N % 4 or N > MAX_STATE or (N // 4) & (N // 4 - 1):
        raise ValueError(f"ssd_decode_step: state size {N}: the kernel "
                         f"takes N / 4 a power of two, N <= {MAX_STATE}")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_decode_step: x/Bm/Cm dtypes {x.dtype}/"
                        f"{Bm.dtype}/{Cm.dtype}; the kernel takes one of "
                        "float32 or bfloat16 for all three")
    if x.shape != (B, H, P):
        raise ValueError(f"ssd_decode_step: x must be ({B}, {H}, {P}), got "
                         f"{tuple(x.shape)}")
    for name, t in (("Bm", Bm), ("Cm", Cm)):
        if t.shape != (B, N):
            raise ValueError(f"ssd_decode_step: {name} must be ({B}, {N}), "
                             f"got {tuple(t.shape)}")
    if dt.dtype != torch.float32 or dt.shape != (B, H) or \
            not dt.is_contiguous():
        raise ValueError(f"ssd_decode_step: dt must be a contiguous ({B}, "
                         f"{H}) float32 tensor")
    for name, t in (("A", A), ("D", D)):
        if t.dtype != torch.float32 or t.shape != (H,) or \
                not t.is_contiguous():
            raise ValueError(f"ssd_decode_step: {name} must be a contiguous "
                             f"({H},) float32 tensor")
    build.check_aligned("ssd_decode_step", "state", state)


def step_args(state, x, dt, A, D, Bm, Cm, y, stream):
    """The argument list of ``repro_ssd_decode_step``
    (``build.SIGNATURES``) for the tensors of a call."""
    B, H, P, N = state.shape
    return (state.data_ptr(), x.data_ptr(), dt.data_ptr(), A.data_ptr(),
            D.data_ptr(), Bm.data_ptr(), Cm.data_ptr(), y.data_ptr(),
            build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")],
            B, H, P, N, *x.stride(), *Bm.stride(), *Cm.stride(), stream)


def ssd_decode_step_bhpn(state, x, dt, A, D, Bm, Cm) -> torch.Tensor:
    """One decode step on the card.

    state: (B, H, P, N) float32, contiguous, updated in place; x: (B, H,
    P); dt: (B, H) float32 after the softplus; A and D: (H,) float32; Bm
    and Cm: (B, N); x, Bm and Cm in one of float32 or bfloat16, read
    through their strides.  Returns a new (B, H, P) tensor y of x's
    dtype."""
    _check(state, x, dt, A, D, Bm, Cm)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    build.launch("ssd_decode_step", x.device, lambda stream: step_args(
        state, x, dt, A, D, Bm, Cm, y, stream))
    return y
