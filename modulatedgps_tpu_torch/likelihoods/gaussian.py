"""Gaussian likelihood with an optionally per-expert noise variance.

Mirrors modulatedgps_tpu/likelihoods/gaussian.py: ``Gaussian.create(0.5,
D=K)`` gives a (1, K) positive variance, one noise level per expert.
"""
from __future__ import annotations

import math

import torch

from ..config import default_float
from ..params import Parameter
from .base import Likelihood

__all__ = ["Gaussian"]

_HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class Gaussian(Likelihood):
    def __init__(self, variance: Parameter):
        super().__init__()
        self.variance = variance

    @classmethod
    def create(cls, variance=1.0, D: int | None = None, *,
               dtype: torch.dtype | None = None,
               device: torch.device | str = "cuda") -> "Gaussian":
        dtype = dtype or default_float()
        v = torch.as_tensor(variance, dtype=dtype, device=device)
        if D is not None:
            v = v * torch.ones((1, D), dtype=dtype, device=device)
        return cls(Parameter.from_value(v, "positive", dtype=dtype,
                                        device=device))

    def log_prob(self, F, Y):
        """log N(Y; F, s2), elementwise."""
        var = self.variance.value
        return -_HALF_LOG_2PI - 0.5 * torch.log(var) - 0.5 * (Y - F).square() / var

    def conditional_mean(self, F):
        return F

    def conditional_variance(self, F):
        return self.variance.value.expand(F.shape)

    def variational_expectations(self, Fmu, Fvar, Y):
        """-0.5 log 2pi - 0.5 log s2 - 0.5 ((Y - Fmu)^2 + Fvar) / s2."""
        var = self.variance.value
        return (-_HALF_LOG_2PI - 0.5 * torch.log(var)
                - 0.5 * ((Y - Fmu).square() + Fvar) / var)

    def predict_mean_and_var(self, Fmu, Fvar):
        return Fmu, Fvar + self.variance.value

    def predict_log_density(self, Fmu, Fvar, Y):
        return self.predict_density_per_expert(Fmu, Fvar, Y).sum(-1)

    def predict_density_per_expert(self, Fmu, Fvar, Y):
        """Elementwise log N(Y; Fmu_k, Fvar_k + s2_k): [..., N, K]."""
        var = Fvar + self.variance.value
        return -_HALF_LOG_2PI - 0.5 * torch.log(var) - 0.5 * (Y - Fmu).square() / var
