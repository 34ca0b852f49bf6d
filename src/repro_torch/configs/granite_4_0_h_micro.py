"""Granite-4.0-H-Micro — hybrid Mamba-2 + NoPE GQA at 9:1, dense SwiGLU.

[https://huggingface.co/ibm-granite/granite-4.0-h-micro, config.json]
40L d_model=2048; attention (32 query heads, 8 kv heads of 64, no
positions, softmax scale 1/64) at layers 5, 15, 25 and 35, Mamba-2 (64
heads of 64, state 128, one group, conv 4 with a bias, chunk 256) at the
other 36; every layer a SwiGLU of 8192; muP scalars: embedding x12,
residual branches x0.22, logits /8; tied embeddings, vocab 100352.
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="granite-4.0-h-micro",
    family="hybrid",
    source="https://huggingface.co/ibm-granite/granite-4.0-h-micro",
    num_layers=40,
    d_model=2048,
    num_heads=32,
    num_kv_heads=8,
    head_dim=64,
    d_ff=8192,
    vocab_size=100352,
    pos_embedding="none",
    attn_every=10,                   # 1 attention : 9 mamba
    attn_offset=5,
    ssm=SSMConfig(state=128, head_dim=64, expand=2, conv_width=4,
                  chunk=256),
    norm_eps=1e-5,
    tie_embeddings=True,
    embedding_multiplier=12.0,
    residual_multiplier=0.22,
    attention_multiplier=0.015625,
    logits_scaling=8.0,
)


def reduced() -> ModelConfig:
    """[ssm, attn, ssm, attn]: the period cut to 2, the offset to 1."""
    return replace(
        CONFIG, num_layers=4, d_model=256, num_heads=4, num_kv_heads=2,
        head_dim=64, d_ff=512, vocab_size=512, attn_every=2, attn_offset=1,
        ssm=SSMConfig(state=32, head_dim=32, expand=2, conv_width=4,
                      chunk=32),
    )
