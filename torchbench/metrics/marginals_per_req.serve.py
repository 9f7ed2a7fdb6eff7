"""marginals_per_req.serve: the calls of the program's span
mgp.posterior.predict_f (a cached layer's marginals) per traced request.
Nothing where the program has no spans."""


def read(ctx):
    work = ctx.get("profiled_work")
    if not work:
        return None
    try:
        from modulatedgps_tpu_torch.utils.profiling import span_table
    except ImportError:
        return None
    row = span_table().get("mgp.posterior.predict_f")
    if row is None:
        return None
    return row["calls"] / len(work)
