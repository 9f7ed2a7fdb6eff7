"""dist_chol_ms.sharded: device milliseconds per step of the distributed
Cholesky (parallel/blocked.py's panel loop, both layers, with its
collectives), forward and pullback: the CUDA-event times of the program's
spans mgp.dist.chol.fwd and .bwd over the traced steps.  Nothing where the
program has no such spans."""
from torchbench.harness.trace import span_ms


def read(ctx):
    return span_ms(ctx, ("mgp.dist.chol.fwd", "mgp.dist.chol.bwd"),
                   "outer_device_ms")
