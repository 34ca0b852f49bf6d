from repro_torch.optim.adamw import (
    OptimizerConfig,
    adamw_update,
    global_norm,
    init_opt_state,
    lr_schedule,
)

__all__ = ["OptimizerConfig", "adamw_update", "global_norm",
           "init_opt_state", "lr_schedule"]
