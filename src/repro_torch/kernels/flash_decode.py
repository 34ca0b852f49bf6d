"""Wrappers of the CUDA single-query decode kernels
(``csrc/flash_decode.cu``): a dense KV cache (with the sliding-window ring
mode) and a paged KV pool.

They replace the TPU kernels ``flash_decode_bkgd`` and
``flash_decode_paged_bkgd`` of the JAX package
(``repro/kernels/flash_decode.py``).  Decode is bound by bytes on the
card: every live K/V line is read once for 2*G*Dh flops.  The design —
one block per (sequence, kv head) serving all G query heads of the group
from each line it loads, walking only the live lines ``[0, pos_b]`` with
an f32 online softmax — is described in the source.  The kernels read the
model layouts through strides: q ``(B, 1, H, Dh)``, the dense cache
``(B, slots, K, Dh)``, the pool ``(num_pages, page_size, K, Dh)``.

The library builds at the first launch, never at import.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build

#: kernel launches since the last reset, per kernel (incremented only
#: where the kernel is launched)
launches = 0
paged_launches = 0

# (q dtype, kv dtype) pairs the kernels take; the output has q's dtype
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}


def _code(dtype) -> int:
    return build.DTYPE_CODES[str(dtype).removeprefix("torch.")]


def _check_common(what, q, k, v, pos):
    for name, t in (("q", q), ("k", k), ("v", v), ("pos", pos)):
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, the kernel "
                             "takes CUDA tensors")
        if t.device != q.device:
            raise ValueError(f"{what}: {name} is not on q's device")
    if (q.dtype, k.dtype) not in _PAIRS or v.dtype != k.dtype:
        raise TypeError(f"{what}: dtypes q={q.dtype} k={k.dtype} "
                        f"v={v.dtype} not taken (pairs: {sorted(map(str, _PAIRS))})")
    if q.dim() != 4 or q.shape[1] != 1:
        raise ValueError(f"{what}: q must be (B, 1, H, Dh), got "
                         f"{tuple(q.shape)}")
    if k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"{what}: k/v must share one 4-d shape, got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: {name} needs unit stride on its "
                             "last (head_dim) axis")
    B, _, H, Dh = q.shape
    K = k.shape[2]
    if k.shape[3] != Dh or H % K:
        raise ValueError(f"{what}: q {tuple(q.shape)} and kv "
                         f"{tuple(k.shape)} disagree on heads or head_dim")
    if not 1 <= Dh <= 128:
        raise ValueError(f"{what}: head_dim {Dh} outside 1..128")
    if pos.dtype != torch.int32 or pos.shape != (B,) or \
            not pos.is_contiguous():
        raise ValueError(f"{what}: pos must be a contiguous ({B},) int32 "
                         f"tensor, got {pos.dtype} {tuple(pos.shape)}")


def flash_decode_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: torch.Tensor, window=None) -> torch.Tensor:
    """Single-query decode attention over a dense cache, on the card.

    q: (B, 1, H, Dh); k/v: (B, S, K, Dh) (slot i = position i, or a ring
    of S slots under ``window``); pos: (B,) int32 — sequence b attends
    slots [0, pos_b], or under ``window`` the wrapped slots holding
    positions (pos_b - window, pos_b].  Returns a new (B, 1, H, Dh)
    tensor of q's dtype."""
    global launches
    _check_common("flash_decode", q, k, v, pos)
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_decode: cache batch {k.shape[0]} != "
                         f"q batch {q.shape[0]}")
    B, _, H, Dh = q.shape
    S, K = k.shape[1], k.shape[2]
    o = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    lib = build.library("flash_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_decode(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            pos.data_ptr(), _code(q.dtype), _code(k.dtype),
            B, H, K, Dh, S, int(window or 0),
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(2),
            Dh ** -0.5, stream)
    build.check(err, "flash_decode")
    launches += 1
    return o


def flash_decode_paged_bshd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, page_table: torch.Tensor,
                            pos: torch.Tensor) -> torch.Tensor:
    """Single-query decode attention over a paged pool, on the card.

    q: (B, 1, H, Dh); k/v: (num_pages, page_size, K, Dh) shared pool;
    page_table: (B, n_pages) int32, logical page -> physical page (0 =
    the null page); pos: (B,) int32 — sequence b attends logical
    positions [0, pos_b], which must lie inside its table row.  Returns a
    new (B, 1, H, Dh) tensor of q's dtype."""
    global paged_launches
    _check_common("flash_decode_paged", q, k, v, pos)
    B, _, H, Dh = q.shape
    ps, K = k.shape[1], k.shape[2]
    if page_table.device != q.device or page_table.dtype != torch.int32 \
            or page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.stride(1) != 1:
        raise ValueError("flash_decode_paged: page_table must be a "
                         f"({B}, n_pages) int32 tensor on q's device with "
                         "unit column stride")
    n_pages = page_table.shape[1]
    o = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    lib = build.library("flash_decode")
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.repro_flash_decode_paged(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            pos.data_ptr(), page_table.data_ptr(),
            _code(q.dtype), _code(k.dtype),
            B, H, K, Dh, n_pages, ps, page_table.stride(0),
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(2),
            Dh ** -0.5, stream)
    build.check(err, "flash_decode_paged")
    paged_launches += 1
    return o
