"""adam_ms.train: device milliseconds per step of the program's span
mgp.adam (the optimizer's step): its CUDA-event times over the traced
steps.  Nothing where the program has no spans."""
from torchbench.harness.trace import span_ms


def read(ctx):
    return span_ms(ctx, ("mgp.adam",), "outer_device_ms")
