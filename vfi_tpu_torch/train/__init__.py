"""Training of the port: the train state and schedules, checkpoints, the
train and eval steps and the Trainer."""

from vfi_tpu_torch.train.checkpoints import CheckpointManager, save_params_npz
from vfi_tpu_torch.train.loop import (Trainer, denormalize_to_uint8,
                                      make_eval_step, make_train_step)
from vfi_tpu_torch.train.state import (CosineScheduler, PlateauScheduler,
                                       TrainState, create_train_state,
                                       get_learning_rate, set_learning_rate)

__all__ = ["CheckpointManager", "CosineScheduler", "PlateauScheduler",
           "TrainState", "Trainer", "create_train_state",
           "denormalize_to_uint8", "get_learning_rate", "make_eval_step",
           "make_train_step", "save_params_npz", "set_learning_rate"]
