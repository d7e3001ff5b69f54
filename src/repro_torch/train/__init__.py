from .trainer import (DecentralizedTrainer, TrainState, lr_schedule,
                      run_training, run_training_scanned)

__all__ = ["DecentralizedTrainer", "TrainState", "lr_schedule",
           "run_training", "run_training_scanned"]
