"""train_points_per_s: every minibatch point of the window's steps over the
whole window, which ends in torch.cuda.synchronize() (host clock)."""


def read(ctx):
    return ctx["points"] / ctx["window_s"]
