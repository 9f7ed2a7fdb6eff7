"""kernel_roofline.train: each traced step's least time, max(FLOPs / peak,
bytes / peak bandwidth), over the device's busy time in the traced
sub-window, in %."""
from torchbench.harness.peaks import roofline_share as read  # noqa: F401
