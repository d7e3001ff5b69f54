from .checkpoint import (restore_checkpoint, restore_train_state,
                         save_checkpoint, save_train_state)
from .trainer import (DecentralizedTrainer, TrainState, lr_schedule,
                      run_training, run_training_scanned)

__all__ = ["DecentralizedTrainer", "TrainState", "lr_schedule",
           "run_training", "run_training_scanned", "save_checkpoint",
           "restore_checkpoint", "save_train_state", "restore_train_state"]
