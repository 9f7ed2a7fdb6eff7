"""allreduce_ms.probe: host milliseconds per all-reduce over the rank's
window."""


def read(ctx):
    return 1e3 * ctx["window_s"] / ctx["rounds"]
