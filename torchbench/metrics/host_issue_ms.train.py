"""host_issue_ms.train: host milliseconds per step in the program's span
mgp.step (make_train_step's step, zero_grad to the optimizer's step: the
host's time to issue the step, with any wait for the card inside it) over
the traced steps, with the profiler on.  Nothing where the program has no
spans."""


def read(ctx):
    work = ctx.get("profiled_work")
    if not work:
        return None
    try:
        from modulatedgps_tpu_torch.utils.profiling import span_table
    except ImportError:
        return None
    row = span_table().get("mgp.step")
    if row is None:
        return None
    return row["host_ms"] / len(work)
