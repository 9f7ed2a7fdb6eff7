"""Stationary covariance functions.

Mirrors modulatedgps_tpu/ops/kernels.py for the kernels of the serving
slice: SquaredExponential and Matern32.  Both build K(X, X2) through
``kxz_kernel.kxz`` at every size (the CUDA kernel on the card, its plain
version on the CPU); the TPU's MIN_DISPATCH_ELEMS threshold does not carry
over.  The other kernels of the JAX package wait for later slices.
"""
from __future__ import annotations

import torch
from torch import nn

from ..params import Parameter
from .kxz_kernel import kxz

__all__ = ["Kernel", "SquaredExponential", "Matern32"]


class Kernel(nn.Module):
    """Base: subclasses implement K(X, X2) and K_diag(X)."""

    def forward(self, X, X2=None, full_cov: bool = True):
        # gpflow's kernel(X, full_cov=False) returns the diagonal.
        if full_cov:
            return self.K(X, X2)
        if X2 is not None:
            raise ValueError("full_cov=False requires X2=None")
        return self.K_diag(X)

    def K(self, X, X2=None):
        raise NotImplementedError

    def K_diag(self, X):
        raise NotImplementedError


class _Stationary(Kernel):
    """Signal variance and (ARD) lengthscales, both positive."""

    kind: str

    def __init__(self, variance: Parameter, lengthscales: Parameter):
        super().__init__()
        self.variance = variance
        self.lengthscales = lengthscales

    @classmethod
    def create(cls, variance=1.0, lengthscales=1.0, *,
               dtype: torch.dtype = torch.float32,
               device: torch.device | str = "cuda"):
        return cls(
            Parameter.from_value(variance, "positive", dtype=dtype, device=device),
            Parameter.from_value(lengthscales, "positive", dtype=dtype,
                                 device=device))

    def K(self, X, X2=None):
        return kxz(X, X if X2 is None else X2, self.lengthscales.value,
                   self.variance.value, kind=self.kind)

    def K_diag(self, X):
        return torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device) \
            * self.variance.value


class SquaredExponential(_Stationary):
    """k(x, z) = variance * exp(-0.5 |(x - z) / lengthscale|^2)."""

    kind = "rbf"


class Matern32(_Stationary):
    """k(r) = variance * (1 + sqrt(3) r) exp(-sqrt(3) r)."""

    kind = "matern32"
