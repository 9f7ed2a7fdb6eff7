"""fwd_ms.train: device milliseconds per step from CUDA events around
the loss call (make_train_step's loss_fn, the model's training_loss), mean over the traced run's window."""


def read(ctx):
    rows = ctx.get("step_ms")
    return sum(r[0] for r in rows) / len(rows) if rows else None
