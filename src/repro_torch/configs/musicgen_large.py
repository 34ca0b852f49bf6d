"""MusicGen-Large — decoder-only over EnCodec tokens. [arXiv:2306.05284]

48L d_model=2048 32H (MHA kv=32) d_ff=8192 vocab=2048 (per codebook).
The EnCodec conv codec frontend is STUBBED: ``models.inputs.make_batch``
provides precomputed frame embeddings (delay-pattern codebook embeddings
already summed).  Non-gated GELU MLP, sinusoidal positions (adapted:
implemented alongside RoPE, selected by config).
"""
from dataclasses import replace

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="musicgen-large",
    family="audio",
    source="arXiv:2306.05284",
    num_layers=48,
    d_model=2048,
    num_heads=32,
    num_kv_heads=32,
    head_dim=64,
    d_ff=8192,
    vocab_size=2048,
    mlp_type="gelu",
    pos_embedding="sinusoidal",
    frontend="audio",
    num_codebooks=4,
)


def reduced() -> ModelConfig:
    return replace(
        CONFIG, num_layers=2, d_model=256, num_heads=4, num_kv_heads=4,
        head_dim=64, d_ff=512, vocab_size=512,
    )
