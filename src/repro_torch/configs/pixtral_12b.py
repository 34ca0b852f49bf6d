"""Pixtral-12B — VLM: pixtral-ViT frontend (STUB) + mistral-nemo decoder.

[hf:mistralai/Pixtral-12B-2409] 40L d_model=5120 32H (GQA kv=8) d_ff=14336
vocab=131072, head_dim=128 (explicit, != d_model/H — Nemo convention).
The vision encoder + projector are stubbed:
``models.inputs.make_batch`` provides precomputed patch embeddings of shape
(batch, num_patches, d_model) consumed as a prefix.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="pixtral-12b",
    family="vlm",
    source="hf:mistralai/Pixtral-12B-2409",
    num_layers=40,
    d_model=5120,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=131072,
    frontend="vision",
    rope_theta=1e6,
)

# patch-embedding prefix length provided by the stub frontend
NUM_PATCHES = 256


def reduced() -> ModelConfig:
    return replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
    )
