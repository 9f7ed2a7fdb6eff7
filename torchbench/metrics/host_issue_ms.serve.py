"""host_issue_ms.serve: host milliseconds per request in the program's
outermost mgp.predict_* spans (predict_y, predict_assign and
predict_density of the served model; predict_density's own
predict_assign left out) over the traced requests, with the profiler on.
Nothing where the program has no spans."""
from torchbench.harness.trace import prefix_ms


def read(ctx):
    return prefix_ms(ctx, "mgp.predict_", "outer_host_ms")
