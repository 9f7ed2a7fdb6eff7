"""glue_ms.train: device milliseconds per step of the loss and backward
outside the custom autograd Functions (the likelihood, the Gumbel weights,
the masks and their autograd backward): the CUDA-event times of the
program's spans mgp.loss and mgp.backward less those of the outermost
ops-level spans (every mgp.*.fwd and mgp.*.bwd) over the traced steps.
Nothing where the program has no spans."""
NAMES = ("mgp.loss", "mgp.backward")


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
    ops = sum(row["outer_device_ms"] or 0.0 for name, row in table.items()
              if name.endswith((".fwd", ".bwd")))
    return (sum(ms) - ops) / len(work)
