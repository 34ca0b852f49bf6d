"""Minitron-4B — pruned Nemotron. [arXiv:2407.14679]

32L d_model=3072 24H (GQA kv=8) d_ff=9216 vocab=256000.  Squared-ReLU MLP
(Nemotron convention), huge vocabulary (sharded on `model`).
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="minitron-4b",
    family="dense",
    source="arXiv:2407.14679",
    num_layers=32,
    d_model=3072,
    num_heads=24,
    num_kv_heads=8,
    head_dim=128,
    d_ff=9216,
    vocab_size=256000,
    mlp_type="relu2",
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
    )
