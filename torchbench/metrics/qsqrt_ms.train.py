"""qsqrt_ms.train: device milliseconds per step of the SVGP layers'
q_sqrt variance term, forward and pullback (the split or one-pass tril
forward, #6/#7 or #8/#9): the CUDA-event times of the program's spans
mgp.atl_sq_colsum.fwd and .bwd over the traced steps.  Nothing where the
program has no spans."""
from torchbench.harness.trace import span_ms


def read(ctx):
    return span_ms(ctx, ("mgp.atl_sq_colsum.fwd", "mgp.atl_sq_colsum.bwd"))
