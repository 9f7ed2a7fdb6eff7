"""train_mfu: the step's required FLOPs (work/<config>.py) over the traced
sub-window's time per step, against the bf16 dense peak, in %."""
from torchbench.harness.peaks import mfu as read  # noqa: F401
