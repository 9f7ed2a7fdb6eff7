"""solve_ms.train: device milliseconds per step of the conditional's
whitened solve, forward and pullback (the Cholesky, the TRSM inverse,
Linv @ Kmn and the pullback's products and banded Cholesky pullback): the
CUDA-event times of the program's spans mgp.whiten_solve.fwd and .bwd over
the traced steps.  Nothing where the program has no spans."""
NAMES = ("mgp.whiten_solve.fwd", "mgp.whiten_solve.bwd")


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
