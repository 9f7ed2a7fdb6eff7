from .adam import Adam
from .loop import make_train_step, run_adam

__all__ = ["Adam", "make_train_step", "run_adam"]
