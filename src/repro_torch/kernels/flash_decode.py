"""Wrappers of the CUDA single-query decode kernel
(``csrc/flash_decode.cu``): a dense KV cache (with the sliding-window ring
mode) and a paged KV pool.

They replace the TPU kernels ``flash_decode_bkgd`` and
``flash_decode_paged_bkgd`` of the JAX package
(``repro/kernels/flash_decode.py``).  Decode is bound by bytes on the
card: every live K/V line is read once for 2*G*Dh flops.  One kernel body
serves both layouts: it splits the lines over blocks as the TPU kernels
split them over grid cells (:func:`split_plan` picks the split length from
shapes alone: the cache's slots, or the table's ``n_pages * page_size``
lines), reads each line with 16-byte copies (a paged block resolves its
lines' pages from the table entries it read once), and combines the f32
partials in the same launch.  The source describes it.  The kernel reads
the model layouts through strides: q ``(B, 1, H, Dh)``, the dense cache
``(B, slots, K, Dh)``, the pool ``(num_pages, page_size, K, Dh)``.

The library builds at the first launch, never at import.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import logits_scale

# (q dtype, kv dtype) pairs the kernels take; the output has q's dtype
_PAIRS = {(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
          (torch.float32, torch.bfloat16)}


#: kv lines of one tile of the kernel; a split is whole tiles
TILE = 32
#: blocks per SM the split plan aims for: on an H100 80GB HBM3 at 700 W
#: about 4 was the fastest at 4 x 512, 1 x 4096 and 4 x 4096 cache lines
#: (``kernel_bench.py --sweep-splits``); shorter splits pay the per-block
#: q load and combine more often, longer ones leave SMs short of blocks
BLOCKS_PER_SM = 4


def split_plan(slots: int, batch: int, kv_heads: int,
               sm_count: int) -> tuple:
    """``(chunk, n_splits)`` of the kernel: the ``slots`` lines (a dense
    cache's slots, or a page table's ``n_pages * page_size``) cut into
    ``n_splits = ceil(slots / chunk)`` runs of ``chunk`` lines (the last
    may be shorter, none is empty), one block each per
    (sequence, kv head).  From shapes alone, never from the positions, so
    choosing it does not synchronise with the card and a captured decode
    step keeps its grid.  It aims at ``BLOCKS_PER_SM`` blocks per SM, in
    whole tiles of ``TILE`` lines."""
    if min(slots, batch, kv_heads, sm_count) < 1:
        raise ValueError(f"split_plan: slots {slots}, batch {batch}, kv "
                         f"heads {kv_heads}, SMs {sm_count} must be >= 1")
    want = -(-BLOCKS_PER_SM * sm_count // (batch * kv_heads))
    chunk = -(-slots // want)
    chunk = -(-chunk // TILE) * TILE
    return chunk, -(-slots // chunk)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


#: per CUDA device, the kernel's (sequence, kv head) counters of finished
#: splits, shared by the dense and paged launches (which run in stream
#: order): zeroed once, and left at zero by every launch
_counters: dict = {}
#: buffers a larger one replaced, kept for good: a CUDA graph captured
#: with one still writes to it (every launch leaves its counters at zero,
#: so launches in stream order stay correct whichever buffer they use)
_retired: list = []


def _counter(device: torch.device, n: int) -> torch.Tensor:
    """At least ``n`` zeroed counters on ``device``: the buffer handed out
    before while it is large enough, else a new one (the old one is never
    freed)."""
    buf = _counters.get(device)
    if buf is None or buf.numel() < n:
        if buf is not None:
            _retired.append(buf)
        buf = torch.zeros(n, dtype=torch.int32, device=device)
        _counters[device] = buf
    return buf


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


def dense_args(q, k, v, o, pos, part, counter, window, chunk, stream,
               scale=None):
    """The argument list of ``repro_flash_decode`` (``build.SIGNATURES``)
    for the tensors of a call; part and counter are the scratch and the
    counters of :func:`flash_decode_bshd`, ``scale`` the logits' (None:
    ``Dh ** -0.5``)."""
    B, _, H, Dh = q.shape
    S, K = k.shape[1], k.shape[2]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            pos.data_ptr(), part.data_ptr(), counter.data_ptr(),
            _code(q.dtype), _code(k.dtype),
            B, H, K, Dh, S, int(window or 0), chunk,
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(2),
            logits_scale(Dh, scale), stream)


def flash_decode_bshd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      pos: torch.Tensor, window=None,
                      scale=None) -> torch.Tensor:
    """Single-query decode attention over a dense cache, on the card.

    q: (B, 1, H, Dh); k/v: (B, S, K, Dh) (slot i = position i, or a ring
    of S slots under ``window``), 16-byte aligned; pos: (B,) int32 —
    sequence b attends slots [0, pos_b], or under ``window`` the wrapped
    slots holding positions (pos_b - window, pos_b]; ``scale`` multiplies
    the logits (None: ``Dh ** -0.5``).  Returns a new
    (B, 1, H, Dh) tensor of q's dtype.  Launches on the current stream;
    calls on two streams of one device at once would share counters."""
    _check_common("flash_decode", q, k, v, pos)
    if k.shape[0] != q.shape[0]:
        raise ValueError(f"flash_decode: cache batch {k.shape[0]} != "
                         f"q batch {q.shape[0]}")
    build.check_aligned("flash_decode", "k", k)
    build.check_aligned("flash_decode", "v", v)
    B, _, H, Dh = q.shape
    S, K = k.shape[1], k.shape[2]
    chunk, n_splits = split_plan(S, B, K, sm_count(q.device.index))
    o = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    part = torch.empty(B * K * n_splits * (H // K) * (Dh + 2),
                       dtype=torch.float32, device=q.device)
    counter = _counter(q.device, B * K)
    build.launch("flash_decode", q.device, lambda stream: dense_args(
        q, k, v, o, pos, part, counter, window, chunk, stream, scale))
    return o


def paged_args(q, k, v, o, page_table, pos, part, counter, chunk, stream,
               scale=None):
    """The argument list of ``repro_flash_decode_paged``
    (``build.SIGNATURES``) for the tensors of a call; part and counter are
    the scratch and the counters of :func:`flash_decode_paged_bshd`,
    ``scale`` the logits' (None: ``Dh ** -0.5``)."""
    B, _, H, Dh = q.shape
    ps, K = k.shape[1], k.shape[2]
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            pos.data_ptr(), page_table.data_ptr(), part.data_ptr(),
            counter.data_ptr(), _code(q.dtype), _code(k.dtype),
            B, H, K, Dh, page_table.shape[1], ps, chunk,
            page_table.stride(0),
            q.stride(0), q.stride(2),
            k.stride(0), k.stride(1), k.stride(2),
            v.stride(0), v.stride(1), v.stride(2),
            o.stride(0), o.stride(2),
            logits_scale(Dh, scale), stream)


def flash_decode_paged_bshd(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, page_table: torch.Tensor,
                            pos: torch.Tensor, scale=None) -> torch.Tensor:
    """Single-query decode attention over a paged pool, on the card.

    q: (B, 1, H, Dh); k/v: (num_pages, page_size, K, Dh) shared pool,
    16-byte aligned; page_table: (B, n_pages) int32, logical page ->
    physical page (0 = the null page); pos: (B,) int32 — sequence b
    attends logical positions [0, pos_b], which must lie inside its table
    row; ``scale`` multiplies the logits (None: ``Dh ** -0.5``).  Returns
    a new (B, 1, H, Dh) tensor of q's dtype.  Launches on the current
    stream; calls on two streams of one device at once would
    share counters."""
    _check_common("flash_decode_paged", q, k, v, pos)
    B, _, H, Dh = q.shape
    ps, K = k.shape[1], k.shape[2]
    if page_table.device != q.device or page_table.dtype != torch.int32 \
            or page_table.dim() != 2 or page_table.shape[0] != B \
            or page_table.stride(1) != 1:
        raise ValueError("flash_decode_paged: page_table must be a "
                         f"({B}, n_pages) int32 tensor on q's device with "
                         "unit column stride")
    build.check_aligned("flash_decode_paged", "k", k)
    build.check_aligned("flash_decode_paged", "v", v)
    chunk, n_splits = split_plan(page_table.shape[1] * ps, B, K,
                                 sm_count(q.device.index))
    o = torch.empty((B, 1, H, Dh), dtype=q.dtype, device=q.device)
    part = torch.empty(B * K * n_splits * (H // K) * (Dh + 2),
                       dtype=torch.float32, device=q.device)
    counter = _counter(q.device, B * K)
    build.launch("flash_decode_paged", q.device, lambda stream: paged_args(
        q, k, v, o, page_table, pos, part, counter, chunk, stream, scale))
    return o
