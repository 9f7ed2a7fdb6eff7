"""serve_mfu: the required FLOPs of the traced sub-window's requests
(work/<config>.py) over that sub-window, against the bf16 dense peak, in
%."""
from torchbench.harness.peaks import mfu as read  # noqa: F401
