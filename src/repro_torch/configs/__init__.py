from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    RunConfig,
    SSMConfig,
    get_config,
    get_reduced_config,
    shape_for,
)

__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig", "MoEConfig",
    "RunConfig", "SSMConfig", "get_config", "get_reduced_config",
    "shape_for",
]
