"""DBRX-132B — fine-grained MoE, 16 experts top-4. [hf:databricks/dbrx-base]

40L d_model=6144 48H (GQA kv=8) d_ff=10752 (per expert) vocab=100352.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="dbrx-132b",
    family="moe",
    source="hf:databricks/dbrx-base",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=8,
    head_dim=128,
    d_ff=0,                              # FFN is MoE in every layer
    vocab_size=100352,
    rope_theta=5e5,
    moe=MoEConfig(num_experts=16, top_k=4, d_ff=10752, every=1),
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, vocab_size=512,
        moe=MoEConfig(num_experts=4, top_k=2, d_ff=256, every=1, group_size=64),
    )
