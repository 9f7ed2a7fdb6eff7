"""predict_ms.serve: device milliseconds per request from CUDA events
around the three predict calls, mean over the traced run's window."""


def read(ctx):
    ms = ctx.get("predict_ms")
    return sum(ms) / len(ms) if ms else None
