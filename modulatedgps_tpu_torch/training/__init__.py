from .adam import Adam
from .checkpoint import restore_checkpoint, save_checkpoint
from .loop import TrainState, make_train_step, run_adam, run_adam_multistart
from .scipy_opt import run_scipy

__all__ = ["Adam", "make_train_step", "restore_checkpoint", "run_adam",
           "run_adam_multistart", "run_scipy", "save_checkpoint", "TrainState"]
