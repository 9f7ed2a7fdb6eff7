"""host_issue_ms.serve: host milliseconds per request in the program's
outermost mgp.predict_* spans (predict_y, predict_assign and
predict_density of the served model; predict_density's own
predict_assign left out) over the traced requests, with the profiler on.
Nothing where the program has no spans."""
PREFIX = "mgp.predict_"


def read(ctx):
    work = ctx.get("profiled_work")
    if not work:
        return None
    try:
        from modulatedgps_tpu_torch.utils.profiling import span_table
    except ImportError:
        return None
    rows = [row for name, row in span_table().items()
            if name.startswith(PREFIX)]
    if not rows:
        return None
    return sum(row["outer_host_ms"] for row in rows) / len(work)
