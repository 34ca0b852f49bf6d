"""Jamba-1.5-Large 398B — hybrid Mamba+attention 1:7 interleave, MoE 16e top-2.

[arXiv:2403.19887] 72L d_model=8192 64H (GQA kv=8) d_ff=24576 vocab=65536.
Jamba block: 8 layers, 1 attention : 7 mamba; MoE FFN every other layer.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig, MoEConfig, SSMConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    source="arXiv:2403.19887",
    num_layers=72,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    head_dim=128,
    d_ff=24576,
    vocab_size=65536,
    attn_every=8,                       # 1 attn : 7 mamba
    moe=MoEConfig(num_experts=16, top_k=2, d_ff=24576, every=2),
    ssm=SSMConfig(state=16, head_dim=64, expand=2, conv_width=4),
    rope_theta=1e6,
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG,
        num_layers=2,
        d_model=256,
        num_heads=4,
        num_kv_heads=2,
        head_dim=64,
        d_ff=512,
        vocab_size=512,
        attn_every=2,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=512, every=2, group_size=64),
        ssm=SSMConfig(state=16, head_dim=32, expand=2, conv_width=4, chunk=32),
    )
