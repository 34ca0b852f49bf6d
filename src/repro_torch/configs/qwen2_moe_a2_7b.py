"""Qwen1.5/2-MoE-A2.7B — 4 shared + 60 routed experts, top-4.

[hf:Qwen/Qwen1.5-MoE-A2.7B] 24L d_model=2048 16H (GQA kv=16) d_ff=1408
(per-expert) vocab=151936, MoE 60e top-4 + 4 shared experts every layer.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="qwen2-moe-a2.7b",
    family="moe",
    source="hf:Qwen/Qwen1.5-MoE-A2.7B",
    num_layers=24,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=0,                              # FFN is MoE in every layer
    vocab_size=151936,
    qkv_bias=True,
    moe=MoEConfig(num_experts=60, top_k=4, num_shared=4, d_ff=1408, every=1),
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, num_shared=1, d_ff=128, every=1,
                      group_size=64),
    )
