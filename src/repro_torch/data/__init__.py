from repro_torch.data.pipeline import (
    DataConfig, PackedStream, PrefetchLoader, EOS, PAD,
)

__all__ = ["DataConfig", "PackedStream", "PrefetchLoader", "EOS", "PAD"]
