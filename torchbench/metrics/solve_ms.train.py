"""solve_ms.train: device milliseconds per step of the conditional's
whitened solve, forward and pullback (the Cholesky, the TRSM inverse,
Linv @ Kmn and the pullback's products and banded Cholesky pullback): the
CUDA-event times of the program's spans mgp.whiten_solve.fwd and .bwd over
the traced steps.  Nothing where the program has no spans."""
from torchbench.harness.trace import span_ms


def read(ctx):
    return span_ms(ctx, ("mgp.whiten_solve.fwd", "mgp.whiten_solve.bwd"))
