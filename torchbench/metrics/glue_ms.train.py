"""glue_ms.train: device milliseconds per step of the loss and backward
outside the custom autograd Functions (the likelihood, the Gumbel weights,
the masks and their autograd backward): the CUDA-event times of the
program's spans mgp.loss and mgp.backward less those of the outermost
ops-level spans (every mgp.*.fwd and mgp.*.bwd) over the traced steps.
Nothing where the program has no spans."""
from torchbench.harness.trace import program_spans, span_ms

NAMES = ("mgp.loss", "mgp.backward")


def read(ctx):
    both = span_ms(ctx, NAMES)
    if both is None:
        return None
    table, n = program_spans(ctx)
    ops = sum(row["outer_device_ms"] or 0.0 for name, row in table.items()
              if name.endswith((".fwd", ".bwd")))
    return both - ops / n
