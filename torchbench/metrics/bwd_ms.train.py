"""bwd_ms.train: device milliseconds per step from CUDA events around
the end of the loss call to the start of the optimizer's step (backward()), mean over the traced run's window."""


def read(ctx):
    rows = ctx.get("step_ms")
    return sum(r[1] for r in rows) / len(rows) if rows else None
