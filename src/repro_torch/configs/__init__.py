from repro_torch.configs.base import (
    ARCH_IDS,
    ModelConfig,
    MoEConfig,
    RunConfig,
    SSMConfig,
    get_config,
    get_reduced_config,
)

__all__ = [
    "ARCH_IDS", "ModelConfig", "MoEConfig", "RunConfig", "SSMConfig",
    "get_config", "get_reduced_config",
]
