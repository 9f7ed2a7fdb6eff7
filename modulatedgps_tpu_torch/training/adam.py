"""Adam with optax's arithmetic over a model's trainable raw parameters.

The update is the one modulatedgps_tpu/training/fused_adam.py:173-178
writes for every leaf, which is optax.adam's at its defaults:

    m' = B1 m + (1 - B1) g
    v' = B2 v + (1 - B2) g^2
    p' = p - lr (m' c1) / (sqrt(v' c2) + EPS),   c = 1 / (1 - B^t).

torch.optim.Adam divides by sqrt(v) / sqrt(c2) instead, which rounds
differently.  Parameters whose ``requires_grad`` is False get no update
(the JAX package masks their gradients to zero, which leaves them
unchanged too).  A lower-triangular leaf keeps zeros above its diagonal:
its gradient is zero there, so are m and v, and p moves by 0 / EPS.
"""
from __future__ import annotations

from typing import Iterable

import torch

__all__ = ["Adam"]

B1, B2, EPS = 0.9, 0.999, 1e-8


class Adam:
    def __init__(self, params: Iterable[torch.Tensor], lr: float):
        self.params = [p for p in params if p.requires_grad]
        self.lr = lr
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
        c1 = 1.0 / (1.0 - B1 ** self.count)
        c2 = 1.0 / (1.0 - B2 ** self.count)
        for p, m, v in zip(self.params, self.m, self.v):
            g = p.grad
            m.mul_(B1).add_(g, alpha=1.0 - B1)
            v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            denom = (v * c2).sqrt_().add_(EPS)
            p.sub_(self.lr * (m * c1) / denom)
