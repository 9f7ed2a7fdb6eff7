"""probe_sums_per_s: the rank's all-reduces over its window (host
clock)."""


def read(ctx):
    return ctx["rounds"] / ctx["window_s"]
