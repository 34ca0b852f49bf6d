"""Wrapper of the CUDA Mamba-2 SSD chunked-scan kernels
(``csrc/ssd_scan.cu``).

Replaces the TPU kernel ``ssd_scan_bhsp`` of the JAX package
(``repro/kernels/ssd_scan.py``).  At the training shape its bound is set
by bytes (the source note gives the arithmetic).  Its design is the
chunk-parallel form of the SSD algorithm: one call makes
:data:`KERNEL_LAUNCHES` launches — C.B^T once per (batch, chunk), each
chunk's own final state (and the cumsum of ``a``), a short pass over the
chunks for the state entering each, then every chunk's output — with the
bf16 products on the tensor cores, the inputs exact and every f32 factor
split into two bf16 terms on the other side of the product.  The kernels
read the model layouts ``x (B, S, H, P)``, ``dt``/``a (B, S, H)`` and
``Bm``/``Cm (B, S, N)`` through strides, so no transpose is
materialised; the wrapper allocates their f32 scratch.

Forward only, as the TPU kernel was: ``kernels.ops.ssd_scan`` wraps it in
an autograd function whose backward recomputes the plain version.  The
library builds at the first launch, never at import.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: wrapper calls that launched the kernels since the last reset
#: (incremented only where they are launched)
launches = 0
#: kernel launches one call makes (csrc/ssd_scan.cu)
KERNEL_LAUNCHES = 4

_DTYPES = (torch.float32, torch.bfloat16)
#: a warp's accumulators cover at most 128 state columns
MAX_STATE = 128
MAX_CHUNK = 4096


def _check(x, dt, a, Bm, Cm, chunk):
    for name, t in (("x", x), ("dt", dt), ("a", a), ("Bm", Bm), ("Cm", Cm)):
        if t.device.type != "cuda":
            raise ValueError(f"ssd_scan: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors")
        if t.device != x.device:
            raise ValueError(f"ssd_scan: {name} is not on x's device")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise TypeError(f"ssd_scan: x/Bm/Cm dtypes {x.dtype}/{Bm.dtype}/"
                        f"{Cm.dtype}; the kernel takes one of float32 or "
                        "bfloat16 for all three")
    if dt.dtype != torch.float32 or a.dtype != torch.float32:
        raise TypeError("ssd_scan: dt and a must be float32")
    if x.dim() != 4:
        raise ValueError(f"ssd_scan: x must be (B, S, H, P), got "
                         f"{tuple(x.shape)}")
    B, S, H, P = x.shape
    if dt.shape != (B, S, H) or a.shape != (B, S, H):
        raise ValueError(f"ssd_scan: dt {tuple(dt.shape)} and a "
                         f"{tuple(a.shape)} must be {(B, S, H)}")
    if Bm.dim() != 3 or Bm.shape[:2] != (B, S) or Cm.shape != Bm.shape:
        raise ValueError(f"ssd_scan: Bm {tuple(Bm.shape)} and Cm "
                         f"{tuple(Cm.shape)} must be (B={B}, S={S}, N)")
    if not 1 <= Bm.shape[2] <= MAX_STATE:
        raise ValueError(f"ssd_scan: state size {Bm.shape[2]} outside "
                         f"1..{MAX_STATE}")
    for name, t in (("x", x), ("Bm", Bm), ("Cm", Cm)):
        if t.stride(-1) != 1:
            raise ValueError(f"ssd_scan: {name} needs unit stride on its "
                             "last axis")
    if not 1 <= chunk <= MAX_CHUNK or S % chunk:
        raise ValueError(f"ssd_scan: chunk {chunk} must divide S={S} and "
                         f"lie in 1..{MAX_CHUNK}")


def scratch(x: torch.Tensor, N: int, chunk: int) -> tuple:
    """The kernels' f32 scratch for a call on ``x``: cs (B, nc, H, 2, Q),
    the cumsum of ``a`` per chunk and a compact copy of ``dt``; cb (B, nc,
    Q, Q), C.B^T per chunk; ds (B, nc, H, P, N), each chunk's own state;
    sin, the same size, the state entering each chunk (for bf16 ``x`` as
    its hi and lo bf16 terms)."""
    B, S, H, P = x.shape
    nc = S // chunk
    return tuple(torch.empty(shape, dtype=torch.float32, device=x.device)
                 for shape in ((B, nc, H, 2, chunk), (B, nc, chunk, chunk),
                               (B, nc, H, P, N), (B, nc, H, P, N)))


def scan_args(x, dt, a, Bm, Cm, y, cs, cb, ds, sin, chunk, stream):
    """The argument list of ``repro_ssd_scan`` (``build.SIGNATURES``) for
    the tensors of a call; cs, cb, ds and sin as :func:`scratch` makes
    them."""
    B, S, H, P = x.shape
    N = Bm.shape[2]
    return (x.data_ptr(), dt.data_ptr(), a.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(), cs.data_ptr(), cb.data_ptr(),
            ds.data_ptr(), sin.data_ptr(),
            build.DTYPE_CODES[str(x.dtype).removeprefix("torch.")],
            B, S, H, P, N, chunk,
            x.stride(0), x.stride(1), x.stride(2),
            dt.stride(0), dt.stride(1), dt.stride(2),
            a.stride(0), a.stride(1), a.stride(2),
            Bm.stride(0), Bm.stride(1),
            Cm.stride(0), Cm.stride(1),
            y.stride(0), y.stride(1), y.stride(2),
            stream)


def ssd_scan_bshp(x: torch.Tensor, dt: torch.Tensor, a: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  chunk: int) -> torch.Tensor:
    """The SSD chunked scan on the card: :data:`KERNEL_LAUNCHES` kernel
    launches on the current stream, counted as one call in
    :data:`launches`.

    x: (B, S, H, P) and Bm/Cm: (B, S, N), float32 or bfloat16 (one dtype),
    unit stride on the last axis; dt and a = dt * A: (B, S, H) float32, any
    strides; S % chunk == 0.  Returns a new contiguous (B, S, H, P) tensor
    of x's dtype; the state and every sum inside are f32."""
    global launches
    _check(x, dt, a, Bm, Cm, chunk)
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    lib = build.library("ssd_scan")
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.repro_ssd_scan(*scan_args(
            x, dt, a, Bm, Cm, y, *scratch(x, Bm.shape[2], chunk), chunk,
            stream))
    build.check(err, "ssd_scan")
    launches += 1
    return y
