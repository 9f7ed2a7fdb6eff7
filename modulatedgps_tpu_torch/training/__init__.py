from .adam import Adam
from .checkpoint import (jax_leaf_names, restore_checkpoint,
                         restore_jax_checkpoint, restore_model,
                         save_checkpoint, save_model)
from .loop import TrainState, make_train_step, run_adam, run_adam_multistart
from .scipy_opt import run_scipy

__all__ = ["Adam", "jax_leaf_names", "make_train_step", "restore_checkpoint",
           "restore_jax_checkpoint", "restore_model", "run_adam",
           "run_adam_multistart", "run_scipy", "save_checkpoint", "save_model",
           "TrainState"]
