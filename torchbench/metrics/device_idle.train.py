"""device_idle.train: 1 - (union of the device's operation intervals) /
(the traced sub-window), in %."""
from torchbench.harness.trace import idle_share as read  # noqa: F401
