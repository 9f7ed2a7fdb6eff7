"""gather_ms.train: host milliseconds per step in minibatch_iterator's
next(), the gather of the batch's rows on the host, without the copy to
the card, over the traced run's window."""


def read(ctx):
    gathers = ctx.get("gathers")
    return 1e3 * sum(gathers) / len(gathers) if gathers else None
