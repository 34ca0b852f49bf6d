from repro_torch.configs.base import (
    ARCH_IDS,
    INPUT_SHAPES,
    InputShape,
    ModelConfig,
    MoEConfig,
    PORT_ARCH_IDS,
    RunConfig,
    SSMConfig,
    default_opt_state_dtype,
    default_run_config,
    get_config,
    get_reduced_config,
    shape_for,
)

__all__ = [
    "ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig", "MoEConfig",
    "PORT_ARCH_IDS",
    "RunConfig", "SSMConfig", "default_opt_state_dtype",
    "default_run_config", "get_config",
    "get_reduced_config", "shape_for",
]
