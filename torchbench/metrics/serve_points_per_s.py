"""serve_points_per_s: every query point served in the window over the
whole window (host clock)."""


def read(ctx):
    return ctx["points"] / ctx["window_s"]
