"""GP prior mean functions.

Mirrors modulatedgps_tpu/ops/mean_functions.py (gpflow's Zero, Constant and
Linear).  ``SVGP(..., mean_function=...)`` adds one to the conditional's
mean; None means Zero and skips the add.  Each maps X [..., N, D] to
[..., N, K], or [..., N, 1] broadcasting over K.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import default_float
from ..params import Parameter

__all__ = ["MeanFunction", "Zero", "Constant", "Linear"]


class MeanFunction(nn.Module):
    def forward(self, X: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError


class Zero(MeanFunction):
    def forward(self, X):
        return torch.zeros((*X.shape[:-1], 1), dtype=X.dtype, device=X.device)


class Constant(MeanFunction):
    """m(x) = c, one constant per output."""

    def __init__(self, c: Parameter):
        super().__init__()
        self.c = c                                         # [K]

    @classmethod
    def create(cls, c=0.0, output_dim: int = 1, *,
               dtype: torch.dtype | None = None,
               device: torch.device | str = "cuda") -> "Constant":
        dtype = dtype or default_float()
        c = torch.as_tensor(c, dtype=dtype, device=device).expand(output_dim)
        return cls(Parameter(c.clone()))

    def forward(self, X):
        c = self.c.value
        return c.expand(*X.shape[:-1], *c.shape)


class Linear(MeanFunction):
    """m(x) = x A + b."""

    def __init__(self, A: Parameter, b: Parameter):
        super().__init__()
        self.A = A                                         # [D, K]
        self.b = b                                         # [K]

    @classmethod
    def create(cls, A, b=0.0, *, dtype: torch.dtype | None = None,
               device: torch.device | str = "cuda") -> "Linear":
        dtype = dtype or default_float()
        A = torch.atleast_2d(torch.as_tensor(A, dtype=dtype, device=device))
        b = torch.as_tensor(b, dtype=dtype, device=device).expand(A.shape[-1])
        return cls(Parameter(A.clone()), Parameter(b.clone()))

    def forward(self, X):
        return torch.matmul(X, self.A.value) + self.b.value
