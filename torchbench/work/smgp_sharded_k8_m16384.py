"""The work of one rank's training step of smgp_sharded_k8_m16384 (see
_count for what counts), and the bytes a rank sends in it, from its shapes.

A rank's required work is the whole step's over the P ranks: its N / P
points of the ring's q_sqrt products and of the full-M solve, a P-th of
the factor and of the rest.  Its bytes sent are what the program's byte
counter counts (parallel/collectives.py: NCCL's ring algorithms), over the
step's forward and its pullbacks.
"""
from torchbench.work import _count

F32 = _count.F32


def train_step(cfg: dict, batch: int) -> dict:
    """One rank's share of a step over a global batch of ``batch``."""
    whole = _count.train_step(cfg, batch)
    return {k: v / cfg["ranks"] for k, v in whole.items()}


def sent_bytes(cfg: dict) -> int:
    """The bytes one rank sends in a step."""
    M, K, D, P, b = cfg["M"], cfg["K"], cfg["D"], cfg["ranks"], cfg["block"]
    w = M // P

    def all_gather(n):
        return (P - 1) * n * F32

    def all_reduce(n):
        return 2 * (P - 1) * n * F32 // P

    panels = M // b
    gathers = all_gather(w * D) + all_gather(w * M) + all_gather(w * K)
    sums = panels * all_reduce(b * b) + 3 * all_reduce(1)   # factor; KL
    ring = (P - 1) * K * M * w * F32                        # its turns
    forward = gathers + panels * all_gather(w * b) + sums + ring
    # The pullbacks send as much, but for the last panel's column, which
    # updates nothing.
    backward = forward - all_gather(w * b)
    fit = 2 * all_reduce(1)                   # the data fit, both ways
    replicated = 2 * 2 + K        # each layer's variance, lengthscale; s2
    return 2 * (forward + backward) + fit + all_reduce(replicated)
