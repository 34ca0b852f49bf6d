"""Input construction — the port of the JAX package's
``models/inputs.py``: abstract inputs on the ``meta`` device for the dry
run (``input_specs``, one entry per model input, the JAX
``ShapeDtypeStruct`` stand-ins) and concrete synthetic batches
(``make_batch``), whose numbers come from one numpy generator in the JAX
draw order, so the same seed gives both packages the same batch.

The modality frontends are stubs, as in the JAX package: VLM batches
carry precomputed patch embeddings (``prefix_embeddings``, at most
``VLM_NUM_PATCHES`` and half the sequence), audio batches precomputed
frame embeddings (``frame_embeddings``), both rounded to bf16.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.device import resolve_device

VLM_NUM_PATCHES = 256


def _train_fields(cfg: ModelConfig, B: int, S: int) -> list:
    """(name, shape, kind) of each batch entry, in the JAX
    ``train_input_specs`` order (kind: "emb" bf16, "int" int32, "mask")."""
    fields = []
    if cfg.frontend == "vision":
        P = min(VLM_NUM_PATCHES, S // 2)
        fields.append(("prefix_embeddings", (B, P, cfg.d_model), "emb"))
        fields.append(("tokens", (B, S - P), "int"))
    elif cfg.frontend == "audio":
        fields.append(("frame_embeddings", (B, S, cfg.d_model), "emb"))
    else:
        fields.append(("tokens", (B, S), "int"))
    fields.append(("labels", (B, S), "int"))
    fields.append(("loss_mask", (B, S), "mask"))
    return fields


_FIELD_DTYPES = {"emb": torch.bfloat16, "int": torch.int32,
                 "mask": torch.float32}


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def train_input_specs(cfg: ModelConfig, shape: InputShape,
                      batch_override: int | None = None) -> dict:
    """The training batch's entries as ``meta`` tensors."""
    B = batch_override or shape.global_batch
    return {name: _meta(shp, _FIELD_DTYPES[kind])
            for name, shp, kind in _train_fields(cfg, B, shape.seq_len)}


def decode_input_specs(cfg: ModelConfig, shape: InputShape,
                       batch_override: int | None = None) -> dict:
    """A decode step's inputs as ``meta`` tensors: one token a slot and
    the position."""
    B = batch_override or shape.global_batch
    return {"token": _meta((B, 1), torch.int32),
            "pos": _meta((), torch.int32)}


def input_specs(cfg: ModelConfig, shape: InputShape,
                batch_override: int | None = None) -> dict:
    if shape.kind == "decode":
        return decode_input_specs(cfg, shape, batch_override)
    return train_input_specs(cfg, shape, batch_override)


def make_batch(cfg: ModelConfig, shape: InputShape, seed: int = 0,
               batch_override: int | None = None, device=None) -> dict:
    """Synthetic training batch on ``device`` (CUDA unless the caller asks
    for another): int32 tokens and labels drawn uniformly from the vocab,
    bf16 stub embeddings ``N(0, 0.02^2)`` and a float32 ``loss_mask``
    (zero on a VLM's image prefix)."""
    dev = resolve_device(device)
    rng = np.random.default_rng(seed)
    B = batch_override or shape.global_batch
    out = {}
    for name, shp, kind in _train_fields(cfg, B, shape.seq_len):
        if kind == "mask":
            m = np.ones(shp, np.float32)
            if cfg.frontend == "vision":
                P = min(VLM_NUM_PATCHES, shape.seq_len // 2)
                m[:, :P] = 0.0          # no loss on the image prefix
            out[name] = torch.from_numpy(m).to(dev)
        elif kind == "int":
            out[name] = torch.from_numpy(
                rng.integers(0, cfg.vocab_size, shp, dtype=np.int32)).to(dev)
        else:
            emb = rng.standard_normal(shp, np.float32) * 0.02
            out[name] = torch.from_numpy(emb).to(dev).to(torch.bfloat16)
    return out
