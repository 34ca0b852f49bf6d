from repro_torch.training.train_step import make_train_step
from repro_torch.training.trainer import Trainer, TrainerConfig

__all__ = ["make_train_step", "Trainer", "TrainerConfig"]
