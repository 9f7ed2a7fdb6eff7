"""marginals_per_req.serve: the calls of the program's span
mgp.posterior.predict_f (a cached layer's marginals) per traced request.
Nothing where the program has no spans."""
from torchbench.harness.trace import span_ms


def read(ctx):
    return span_ms(ctx, ("mgp.posterior.predict_f",), "calls")
