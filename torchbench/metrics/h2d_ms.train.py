"""h2d_ms.train: device milliseconds per step of host-to-device copies
(the batch moved to the card) in the traced sub-window."""


def read(ctx):
    trace, work = ctx.get("trace"), ctx.get("profiled_work")
    if trace is None or not work:
        return None
    s = sum(v for k, v in trace.op_seconds.items() if "HtoD" in k)
    return 1e3 * s / len(work) if s else None
