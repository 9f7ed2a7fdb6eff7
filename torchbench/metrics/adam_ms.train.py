"""adam_ms.train: device milliseconds per step from CUDA events around
the Adam instance's step, mean over the traced run's window."""


def read(ctx):
    rows = ctx.get("step_ms")
    return sum(r[2] for r in rows) / len(rows) if rows else None
