from facl_tpu_torch.train.checkpoint import (latest_checkpoint,
                                             restore_checkpoint,
                                             restore_latest, save_checkpoint)
from facl_tpu_torch.train.optim import make_optimizer, step_decay_schedule
from facl_tpu_torch.train.state import TrainState
from facl_tpu_torch.train.trainer import (Trainer, make_eval_step,
                                          make_grouping_fn, make_train_step)
from facl_tpu_torch.train.moco_trainer import (MoCoTrainer, MoCoTrainState,
                                               make_moco_step,
                                               shard_moco_state)
from facl_tpu_torch.train.slowfast_trainer import (SlowFastTrainer,
                                                   SlowFastTrainState,
                                                   make_slowfast_step)

__all__ = ["MoCoTrainState", "MoCoTrainer", "SlowFastTrainState",
           "SlowFastTrainer", "TrainState", "Trainer", "latest_checkpoint",
           "make_eval_step", "make_grouping_fn", "make_moco_step",
           "make_optimizer", "make_slowfast_step", "make_train_step",
           "restore_checkpoint", "restore_latest", "save_checkpoint",
           "shard_moco_state", "step_decay_schedule"]
