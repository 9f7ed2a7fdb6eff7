"""qsqrt_ms.train: device milliseconds per step of the SVGP layers'
q_sqrt variance term, forward and pullback (the split or one-pass tril
forward, #6/#7 or #8/#9): the CUDA-event times of the program's spans
mgp.atl_sq_colsum.fwd and .bwd over the traced steps.  Nothing where the
program has no spans."""
NAMES = ("mgp.atl_sq_colsum.fwd", "mgp.atl_sq_colsum.bwd")


def read(ctx):
    work = ctx.get("profiled_work")
    if not work:
        return None
    try:
        from modulatedgps_tpu_torch.utils.profiling import span_table
    except ImportError:
        return None
    table = span_table()
    ms = [table[n]["device_ms"] for n in NAMES if n in table]
    if len(ms) < len(NAMES) or None in ms:
        return None
    return sum(ms) / len(work)
