"""setup_s: process start to the first timed step or request (host clock):
imports, the CUDA context, the kernel library (built on a checkout's first
run), the state and data made from the seed, the checked and warm-up steps
or the posterior cache and warm-up requests."""


def read(ctx):
    return ctx["setup_s"]
