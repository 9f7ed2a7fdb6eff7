"""fwd_ms.train: device milliseconds per step of the program's span
mgp.loss (make_train_step's loss call, the model's training_loss): its
CUDA-event times over the traced steps.  Nothing where the program has no
spans."""
from torchbench.harness.trace import span_ms


def read(ctx):
    return span_ms(ctx, ("mgp.loss",), "outer_device_ms")
