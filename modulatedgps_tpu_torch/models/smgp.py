"""Mixture of SVGPs with GP-modulated data association (SMGP): prediction.

Mirrors the prediction methods of modulatedgps_tpu/models/smgp.py.  K
experts share the inputs; the prediction layer gives per-expert latents
f_k and the assignment layer gives the logits of the mixture weights.  A
layer is anything with ``predict_f(X) -> ([N, K], [N, K])``: a trained
``SVGP`` (the training-path conditional) or a ``PrecomputedPosterior``
(the cached serving path, see posterior.precompute_smgp).  Sampling and
the ELBO wait for the training slice.
"""
from __future__ import annotations

import torch
from torch import nn

from ..likelihoods.base import Likelihood

__all__ = ["SGP", "SMGP"]


class SGP(nn.Module):
    """One prediction layer and a likelihood."""

    def __init__(self, likelihood: Likelihood, pred_layer: nn.Module, *,
                 num_samples: int = 1, num_data: int | None = None):
        super().__init__()
        self.likelihood = likelihood
        self.pred_layer = pred_layer
        self.num_samples = num_samples
        self.num_data = num_data

    def predict_y(self, Xnew, S: int = 1):
        """Per-expert predictive moments, tiled to [S, N, K] (rows are
        identical across S)."""
        Fmu, Fvar = self.pred_layer.predict_f(Xnew)
        mean, var = self.likelihood.predict_mean_and_var(Fmu, Fvar)
        return mean.expand(S, *mean.shape), var.expand(S, *var.shape)


class SMGP(SGP):
    def __init__(self, likelihood: Likelihood, pred_layer: nn.Module,
                 assign_layer: nn.Module, *, K: int = 3, num_samples: int = 1,
                 num_data: int | None = None, temperature: float = 1e-2):
        super().__init__(likelihood, pred_layer, num_samples=num_samples,
                         num_data=num_data)
        self.assign_layer = assign_layer
        self.K = K
        self.temperature = temperature

    def predict_assign(self, Xnew):
        """softmax of the mean assignment logits: [N, K]."""
        amu, _ = self.assign_layer.predict_f(Xnew)
        return torch.softmax(amu, dim=-1)

    def predict_density(self, Xnew, Ynew):
        """Mixture predictive log-density log sum_k pi_k(x) p_k(y|x): [N]."""
        pi = self.predict_assign(Xnew)                           # [N, K]
        Fmu, Fvar = self.pred_layer.predict_f(Xnew)
        log_pk = self.likelihood.predict_density_per_expert(Fmu, Fvar, Ynew)
        return torch.logsumexp(torch.log(pi + 1e-12) + log_pk, dim=-1)
