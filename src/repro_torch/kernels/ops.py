"""Model-layout entry points of the attention kernels.

The contract is that of the JAX package's ``kernels/ops.py``:
``flash_attention``, ``flash_decode(window=)`` and ``flash_decode_paged``
take model-layout tensors and return model-layout outputs.  Dispatch goes
by the tensors' device: a CUDA tensor launches the hand-written kernel
(which reads the model layout through strides, so no transpose is
materialised); a CPU tensor runs the kernel's plain version.  Nothing
falls back: a kernel that fails to build or launch raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_decode as _fd
from repro_torch.kernels import ref


def _on_card(t: torch.Tensor) -> bool:
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no attention kernel for device {t.device}")


def flash_attention(q, k, v, window=None):
    """q: (B, S, H, Dh); k/v: (B, S, K, Dh) -> (B, S, H, Dh).  Causal."""
    if _on_card(q):
        return _fa.flash_attention_bshd(q, k, v, window=window)
    return ref.attention_ref(q, k, v, window=window)


def flash_decode(q, k, v, pos, window=None):
    """q: (B, 1, H, Dh) roped query; k/v: (B, S, K, Dh) KV cache; pos:
    (B,) int32 — attends slots [0, pos_b], or the ring's wrapped slots
    under ``window``.  Returns (B, 1, H, Dh)."""
    if _on_card(q):
        return _fd.flash_decode_bshd(q, k, v, pos, window=window)
    return ref.decode_attention_ref(q, k, v, pos, window=window)


def flash_decode_paged(q, k, v, page_table, pos):
    """q: (B, 1, H, Dh); k/v: (num_pages, page_size, K, Dh) pool;
    page_table: (B, n_pages) int32; pos: (B,) int32 — attends logical
    positions [0, pos_b].  Returns (B, 1, H, Dh)."""
    if _on_card(q):
        return _fd.flash_decode_paged_bshd(q, k, v, page_table, pos)
    return ref.paged_decode_attention_ref(q, k, v, page_table, pos)


def launch_counts() -> dict:
    """Kernel launches since the last :func:`reset_launch_counts`."""
    return {"flash_attention": _fa.launches,
            "flash_decode": _fd.launches,
            "flash_decode_paged": _fd.paged_launches}


def reset_launch_counts():
    _fa.launches = 0
    _fd.launches = 0
    _fd.paged_launches = 0
