"""launches_per_req.serve: the device operations (kernels, memsets and
copies) of the traced sub-window per request."""


def read(ctx):
    trace, work = ctx.get("trace"), ctx.get("profiled_work")
    return trace.ops / len(work) if trace is not None and work else None
