"""Covariance functions.

Mirrors modulatedgps_tpu/ops/kernels.py: SquaredExponential, Matern12,
Matern32, Matern52, White, Constant, Sum and Product.  SquaredExponential
and Matern32 build K(X, X2) through ``kxz_kernel.kxz`` at every size (the
CUDA kernel #1 on the card, its plain version on the CPU), also inside a
Sum or a Product; the TPU's MIN_DISPATCH_ELEMS threshold does not carry
over.  The others are torch ops, as the JAX package leaves them to XLA:
Matern12 and Matern52 on ``square_distance``, whose cross term is an fp32
matmul (TF32 is off for the whole package, as the TPU ran it at HIGHEST).
Sum and Product hold their terms in an ``nn.ModuleList`` named
``kernels``, so a term's leaves are named ``kernels.0.variance.raw``, the
JAX pytree's own paths.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..config import default_float
from ..params import Parameter
from .kxz_kernel import kxz

__all__ = ["Kernel", "SquaredExponential", "Matern12", "Matern32", "Matern52",
           "White", "Constant", "Sum", "Product", "square_distance"]


def square_distance(X: torch.Tensor, X2: torch.Tensor | None) -> torch.Tensor:
    """Pairwise squared distance [..., N, D] x [..., M, D] -> [..., N, M]:
    |x|^2 + |z|^2 - 2 x.z, clamped at 0."""
    if X2 is None:
        X2 = X
    Xs = X.square().sum(-1)
    X2s = X2.square().sum(-1)
    cross = X @ X2.transpose(-1, -2)
    return (Xs[..., :, None] + X2s[..., None, :] - 2.0 * cross).clamp_min(0.0)


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

    def __add__(self, other: "Kernel") -> "Sum":
        return Sum([self, other])

    def __mul__(self, other: "Kernel") -> "Product":
        return Product([self, other])


def _positive(value, dtype, device) -> Parameter:
    return Parameter.from_value(value, "positive", dtype=dtype or default_float(),
                                device=device)


class _Stationary(Kernel):
    """Signal variance and (ARD) lengthscales, both positive."""

    def __init__(self, variance: Parameter, lengthscales: Parameter):
        super().__init__()
        self.variance = variance
        self.lengthscales = lengthscales

    @classmethod
    def create(cls, variance=1.0, lengthscales=1.0, *,
               dtype: torch.dtype | None = None,
               device: torch.device | str = "cuda"):
        return cls(_positive(variance, dtype, device),
                   _positive(lengthscales, dtype, device))

    def scaled_square_distance(self, X, X2=None):
        ls = self.lengthscales.value
        return square_distance(X / ls, None if X2 is None else X2 / ls)

    def K_diag(self, X):
        return torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device) \
            * self.variance.value


class _KxzStationary(_Stationary):
    """A kernel of csrc/kxz.cu: K(X, X2) of [N, D] inputs by ``kxz``."""

    kind: str

    def K(self, X, X2=None):
        return kxz(X, X if X2 is None else X2, self.lengthscales.value,
                   self.variance.value, kind=self.kind)


class SquaredExponential(_KxzStationary):
    """k(x, z) = variance * exp(-0.5 |(x - z) / lengthscale|^2)."""

    kind = "rbf"


class Matern32(_KxzStationary):
    """k(r) = variance * (1 + sqrt(3) r) exp(-sqrt(3) r)."""

    kind = "matern32"


class Matern12(_Stationary):
    """k(r) = variance * exp(-r)."""

    def K(self, X, X2=None):
        r = torch.sqrt(self.scaled_square_distance(X, X2) + 1e-36)
        return self.variance.value * torch.exp(-r)


class Matern52(_Stationary):
    """k(r) = variance * (1 + sqrt(5) r + 5/3 r^2) exp(-sqrt(5) r)."""

    def K(self, X, X2=None):
        r2 = self.scaled_square_distance(X, X2)
        r = torch.sqrt(r2 + 1e-36)
        s5r = math.sqrt(5.0) * r
        return self.variance.value * (1.0 + s5r + 5.0 / 3.0 * r2) \
            * torch.exp(-s5r)


class _VarianceOnly(Kernel):
    def __init__(self, variance: Parameter):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance=1.0, *, dtype: torch.dtype | None = None,
               device: torch.device | str = "cuda"):
        return cls(_positive(variance, dtype, device))

    def K_diag(self, X):
        return torch.ones(X.shape[:-1], dtype=X.dtype, device=X.device) \
            * self.variance.value


class White(_VarianceOnly):
    """variance * I on K(X), zeros on K(X, X2) (gpflow's White)."""

    def K(self, X, X2=None):
        if X2 is None:
            n = X.shape[-2]
            eye = torch.eye(n, dtype=X.dtype, device=X.device)
            return self.variance.value * eye.expand(*X.shape[:-1], n)
        lead = torch.broadcast_shapes(X.shape[:-2], X2.shape[:-2])
        return torch.zeros((*lead, X.shape[-2], X2.shape[-2]), dtype=X.dtype,
                           device=X.device)


class Constant(_VarianceOnly):
    """k(x, z) = variance."""

    def K(self, X, X2=None):
        if X2 is None:
            X2 = X
        lead = torch.broadcast_shapes(X.shape[:-2], X2.shape[:-2])
        return torch.ones((*lead, X.shape[-2], X2.shape[-2]), dtype=X.dtype,
                          device=X.device) * self.variance.value


class _Combination(Kernel):
    def __init__(self, kernels):
        super().__init__()
        self.kernels = nn.ModuleList(kernels)

    def K(self, X, X2=None):
        out = self.kernels[0].K(X, X2)
        for k in self.kernels[1:]:
            out = self._combine(out, k.K(X, X2))
        return out

    def K_diag(self, X):
        out = self.kernels[0].K_diag(X)
        for k in self.kernels[1:]:
            out = self._combine(out, k.K_diag(X))
        return out


class Sum(_Combination):
    @staticmethod
    def _combine(a, b):
        return a + b


class Product(_Combination):
    @staticmethod
    def _combine(a, b):
        return a * b
