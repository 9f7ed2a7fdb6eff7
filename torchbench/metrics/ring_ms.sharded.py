"""ring_ms.sharded: device milliseconds per step of the q_sqrt term's
ppermute ring (parallel/inducing.py's _quad_ring, both layers, with its
collectives), forward and pullback: the CUDA-event times of the program's
spans mgp.dist.ring.fwd and .bwd over the traced steps.  Nothing where the
program has no such spans."""
from torchbench.harness.trace import span_ms


def read(ctx):
    return span_ms(ctx, ("mgp.dist.ring.fwd", "mgp.dist.ring.bwd"),
                   "outer_device_ms")
