"""host_issue_ms.train: host milliseconds per step in the program's span
mgp.step (make_train_step's step, zero_grad to the optimizer's step: the
host's time to issue the step, with any wait for the card inside it) over
the traced steps, with the profiler on.  Nothing where the program has no
spans."""
from torchbench.harness.trace import span_ms


def read(ctx):
    return span_ms(ctx, ("mgp.step",), "host_ms")
