"""Concrete synthetic batches for token configs — the port of
``make_batch`` from the JAX package's ``models/inputs.py``.  The numbers
come from a numpy generator, so the same seed gives both packages the
same batch.  The VLM and audio stubs come with their families."""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device


def make_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
               batch_override: int | None = None, device=None) -> dict:
    """``{tokens, labels}`` int32 (B, S) drawn uniformly from the vocab and
    ``loss_mask`` float32 ones, on ``device`` (CUDA unless the caller asks
    for another)."""
    if cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: {cfg.frontend} batches come with the VLM/audio "
            "slice (ROADMAP A3)")
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B = batch_override or shape.global_batch
    S = shape.seq_len
    out = {}
    for k in ("tokens", "labels"):
        out[k] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S), dtype=np.int32)).to(dev)
    out["loss_mask"] = torch.ones((B, S), dtype=torch.float32, device=dev)
    return out
