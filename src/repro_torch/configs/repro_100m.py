"""repro-100m — the paper's own workload: a ~100M-parameter dense GQA
transformer sized for the end-to-end CPU training example (examples/
train_cluster.py).  Not one of the ten architectures (`ARCH_IDS`).
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="repro-100m",
    family="dense",
    source="this repo (examples/train_cluster.py)",
    num_layers=12,
    d_model=768,
    num_heads=12,
    num_kv_heads=4,
    head_dim=64,
    d_ff=3072,
    vocab_size=32_000,
    mlp_type="swiglu",
)


def reduced() -> ModelConfig:
    return replace(CONFIG, num_layers=2, d_model=256, num_heads=4,
                   num_kv_heads=2, vocab_size=512, d_ff=1024)
