"""Device selection of the port's entry points."""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller
    passes another device (``"cpu"``, as the tests do).  A CUDA device
    that is not there raises; nothing falls back to the CPU.

    Also pins float32 matrix products and convolutions to full f32 on
    the card: ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.backends.cudnn.allow_tf32 = False`` (TF32 keeps ~3 decimal
    digits; the port is held against an f32 reference)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' (CLI: --device cpu) to run the "
            "plain versions on the CPU")
    return dev
