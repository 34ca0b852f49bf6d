"""StarCoder2-3B — dense, GQA kv=2, RoPE. [arXiv:2402.19173]

30L d_model=3072 24H (GQA kv=2) d_ff=12288 vocab=49152.  Non-gated GELU MLP.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-3b",
    family="dense",
    source="arXiv:2402.19173",
    num_layers=30,
    d_model=3072,
    num_heads=24,
    num_kv_heads=2,
    head_dim=128,
    d_ff=12288,
    vocab_size=49152,
    mlp_type="gelu",
    qkv_bias=True,
    rope_theta=1e5,
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512,
    )
