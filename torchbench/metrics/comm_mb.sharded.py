"""comm_mb.sharded: megabytes (1e6 bytes) one rank sends per step in the
collectives: the program's counters mgp.dist.sent.* (the bytes of NCCL's
ring algorithms, counted from the shapes) over the traced steps.  Nothing
where the program has no such counters."""

PREFIX = "mgp.dist.sent."


def read(ctx):
    work = ctx.get("profiled_work")
    if not work:
        return None
    try:
        from modulatedgps_tpu_torch.utils.profiling import counter_table
    except ImportError:
        return None
    sent = [row["total"] for name, row in counter_table().items()
            if name.startswith(PREFIX)]
    return sum(sent) / 1e6 / len(work) if sent else None
