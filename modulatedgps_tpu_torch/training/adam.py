"""Adam with optax's arithmetic over a model's trainable raw parameters.

The update is the one modulatedgps_tpu/training/fused_adam.py:173-178
writes for every leaf, which is optax.adam's at its defaults
(fused_adam.adam_update).  torch.optim.Adam divides by sqrt(v) / sqrt(c2)
instead, which rounds differently.

The raw tensor of every "tril" Parameter (the [K, M, M] q_sqrt leaves)
goes through ``adam_tril_``: kernel #14 on the card, its plain version on
the CPU, updating p, m and v in place on and below the diagonal only.  The
upper triangle of such a leaf keeps its bits and its m and v stay 0 there.
Tril-ness is the Parameter's transform, not the leaf's shape.  Every other
leaf takes the elementwise update.  b1, b2 and eps are the instance's
(optax's defaults unless given), as JAX's FusedAdam(lr, b1, b2, eps).  Parameters whose ``requires_grad`` is
False get no update (the JAX package masks their gradients to zero, which
leaves them unchanged too).  The bias corrections are computed on the host
in double from the step count, so a step never waits on the card.
"""
from __future__ import annotations

import torch
from torch import nn

from ..params import Parameter
from .fused_adam import B1, B2, EPS, adam_tril_, adam_update

__all__ = ["Adam"]


class Adam:
    """Adam over ``model``'s trainable raw parameters; ``names`` are their
    names in ``model.named_parameters()``."""

    def __init__(self, model: nn.Module, lr: float, b1: float = B1,
                 b2: float = B2, eps: float = EPS):
        tril = {id(mod.raw) for mod in model.modules()
                if isinstance(mod, Parameter) and mod.transform == "tril"}
        named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        self.tril = [id(p) in tril for p in self.params]
        self.lr, self.b1, self.b2, self.eps = lr, b1, b2, eps
        self.count = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self) -> None:
        """One update of every parameter from its ``.grad``."""
        self.count += 1
        c1 = 1.0 / (1.0 - self.b1 ** self.count)
        c2 = 1.0 / (1.0 - self.b2 ** self.count)
        hyper = (self.b1, self.b2, self.eps)
        for p, m, v, tril in zip(self.params, self.m, self.v, self.tril):
            if tril:
                adam_tril_(p, p.grad, m, v, self.lr, c1, c2, *hyper)
                continue
            for old, new in zip((p, m, v), adam_update(p, p.grad, m, v, self.lr,
                                                       c1, c2, *hyper)):
                old.copy_(new)
