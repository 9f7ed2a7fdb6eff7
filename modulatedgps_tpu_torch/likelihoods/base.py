"""Likelihood interface.

Mirrors modulatedgps_tpu/likelihoods/base.py.  Shapes: Fmu, Fvar [..., N, K]
latent marginals, Y [N, D] observations (D=1 targets, or D=K).
``variational_expectations`` returns [..., N, K] for Gaussian(D=K) and
[..., N, 1] for MultiClass and Bernoulli with one latent, the shapes the
SMGP's weighting by W [S, N, K] and sum over K expect.
"""
from __future__ import annotations

from torch import nn

__all__ = ["Likelihood"]


class Likelihood(nn.Module):
    def log_prob(self, F, Y):
        """log p(Y | F)."""
        raise NotImplementedError

    def variational_expectations(self, Fmu, Fvar, Y):
        """E_{f ~ N(Fmu, Fvar)}[log p(Y | f)]."""
        raise NotImplementedError

    def predict_mean_and_var(self, Fmu, Fvar):
        """Moments of the predictive p(y*) = int p(y|f) N(f; Fmu, Fvar) df."""
        raise NotImplementedError

    def predict_log_density(self, Fmu, Fvar, Y):
        raise NotImplementedError

    def predict_density_per_expert(self, Fmu, Fvar, Y):
        """log p_k(y|x) under each expert k's marginals: [..., N, K].

        Default for likelihoods that couple all K latents into one density:
        every expert gets the same predictive density.
        """
        ld = self.predict_log_density(Fmu, Fvar, Y)            # [..., N]
        return ld[..., None].expand(*ld.shape, Fmu.shape[-1])
