"""Bernoulli likelihood with the probit link.

Mirrors modulatedgps_tpu/likelihoods/bernoulli.py: inv_probit squeezed into
[1e-3, 1 - 1e-3]; Y in {0, 1}.  The variational expectation is a
Gauss-Hermite quadrature per latent; the predictive density is per latent
(per expert), [..., N, K].
"""
from __future__ import annotations

import torch

from ..ops.quadrature import (DEFAULT_NUM_POINTS, gauss_hermite_expectation,
                              sqrt_const)
from .base import Likelihood

__all__ = ["Bernoulli", "inv_probit"]

_JITTER = 1e-3


def inv_probit(x: torch.Tensor) -> torch.Tensor:
    return (0.5 * (1.0 + torch.erf(x / sqrt_const(2.0, x.dtype)))
            * (1 - 2 * _JITTER) + _JITTER)


class Bernoulli(Likelihood):
    def __init__(self, num_gauss_hermite_points: int = DEFAULT_NUM_POINTS):
        super().__init__()
        self.num_gauss_hermite_points = num_gauss_hermite_points

    def log_prob(self, F, Y):
        p = inv_probit(F)
        return torch.log(torch.where(Y > 0.5, p, 1.0 - p))

    def variational_expectations(self, Fmu, Fvar, Y):
        return gauss_hermite_expectation(
            lambda f: self.log_prob(f, Y[..., None]), Fmu, Fvar,
            self.num_gauss_hermite_points)

    def predict_mean_and_var(self, Fmu, Fvar):
        p = inv_probit(Fmu / torch.sqrt(1.0 + Fvar))
        return p, p - p.square()

    def predict_log_density(self, Fmu, Fvar, Y):
        return self.predict_density_per_expert(Fmu, Fvar, Y).sum(-1)

    def predict_density_per_expert(self, Fmu, Fvar, Y):
        """Per-latent Bernoulli log-density, [..., N, K]."""
        p, _ = self.predict_mean_and_var(Fmu, Fvar)
        return torch.log(torch.where(Y > 0.5, p, 1.0 - p))
