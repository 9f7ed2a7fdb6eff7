"""predict_ms.serve: device milliseconds per request of the program's
outermost mgp.predict_* spans (predict_y, predict_assign and
predict_density of the served model; predict_density's own
predict_assign left out): their CUDA-event times over the traced
requests.  Nothing where the program has no spans."""
from torchbench.harness.trace import prefix_ms


def read(ctx):
    return prefix_ms(ctx, "mgp.predict_", "outer_device_ms")
