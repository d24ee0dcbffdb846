from facl_tpu_torch.train.checkpoint import (latest_checkpoint,
                                             restore_checkpoint,
                                             restore_latest, save_checkpoint)
from facl_tpu_torch.train.optim import make_optimizer, step_decay_schedule
from facl_tpu_torch.train.state import TrainState
from facl_tpu_torch.train.trainer import (Trainer, make_eval_step,
                                          make_grouping_fn, make_train_step)

__all__ = ["TrainState", "Trainer", "latest_checkpoint", "make_eval_step",
           "make_grouping_fn", "make_optimizer", "make_train_step",
           "restore_checkpoint", "restore_latest", "save_checkpoint",
           "step_decay_schedule"]
