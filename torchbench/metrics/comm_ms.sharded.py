"""comm_ms.sharded: device milliseconds per step in the collectives
(parallel/collectives.py, forward and pullback, and the replicated
gradients' all-reduce): the CUDA-event times of the program's spans
mgp.dist.comm.* over the traced steps, on the compute stream, so each
holds the wait for the other ranks.  Nothing where the program has no such
spans."""
from torchbench.harness.trace import prefix_ms


def read(ctx):
    return prefix_ms(ctx, "mgp.dist.comm.", "outer_device_ms")
