"""Mamba2-780M — attention-free SSD (state-space duality). [arXiv:2405.21060]

48L d_model=1536, d_inner=3072, ssm_state=128, headdim=64 (48 SSD heads),
vocab=50280.  ``long_500k`` runs natively (O(1) recurrent decode state).
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-780m",
    family="ssm",
    source="arXiv:2405.21060",
    num_layers=48,
    d_model=1536,
    num_heads=0,
    num_kv_heads=0,
    head_dim=0,
    d_ff=0,                          # mamba blocks have no separate FFN
    vocab_size=50280,
    attn_every=0,                    # attention-free
    ssm=SSMConfig(state=128, head_dim=64, expand=2, conv_width=4),
    tie_embeddings=True,
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG, num_layers=2, d_model=256, vocab_size=512,
        ssm=SSMConfig(state=32, head_dim=32, expand=2, conv_width=4, chunk=32),
    )
