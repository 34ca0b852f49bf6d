from repro_torch.training.train_step import (
    make_train_step, train_step_lowering_args,
)
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["make_train_step", "train_step_lowering_args", "Trainer",
           "TrainerConfig"]
