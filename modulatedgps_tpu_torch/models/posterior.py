"""Precomputed SVGP posterior: the serving path.

Mirrors modulatedgps_tpu/models/posterior.py.  All X-independent algebra
is done once per parameter update, so a prediction batch costs one kernel
build and K+2 matmuls, with no Cholesky or solves:

    fmean  = Kxz @ alpha,                  alpha = L^-T q_mu          [M, K]
    fvar_k = Kdiag + |S_k^T a|^2 - |a|^2,  a = L^-1 k(Z, x)           [M]

for a whitened layer, S = tril q_sqrt.  An unwhitened layer caches
alpha = L^-T (L^-1 q_mu) = Kmm^-1 q_mu and S_k = L^-1 tril q_sqrt_k (the
JAX package's ``LS``, a plain matmul of two lower-triangular factors) and
serves the same formula.

The JAX package folds the variance into Q_k = L^-T (S_k S_k^T - I) L^-1
and evaluates k^T Q_k k.  That is the same quantity, but in float32 it
cancels catastrophically: at the north-star state (M=4096, perturbed
q_sqrt) Q has entries of ~1e5 while fvar is O(1), and the Q form was
measured 10-22% off the float64 variance on an H100, against 1.2% for the
training-path conditional.  The port therefore caches the factors
(L^-1 and S = tril q_sqrt) and takes each squared norm on its own, which
keeps the float32 error at the conditional's level.  The unwhitened branch
takes the same factor form rather than JAX's Q = Kmm^-1 (S S^T - Kmm)
Kmm^-1, for the same reason.
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.conditionals import expand_independent_outputs
from ..ops.kernels import Kernel
from ..ops.linalg import cholesky, triangular_inverse

__all__ = ["PrecomputedPosterior", "precompute_posterior", "precompute_smgp"]


class PrecomputedPosterior(nn.Module):
    def __init__(self, kernel: Kernel, Z: torch.Tensor, alpha: torch.Tensor,
                 Linv: torch.Tensor, S: torch.Tensor):
        super().__init__()
        self.kernel = kernel
        self.register_buffer("Z", Z)            # [M, D]
        self.register_buffer("alpha", alpha)    # [M, K]
        self.register_buffer("Linv", Linv)      # [M, M] lower
        self.register_buffer("S", S)            # [K, M, M] lower

    def predict_f(self, Xnew: torch.Tensor, *, full_output_cov: bool = False):
        """Marginal posterior mean and variance at Xnew [N, D]: ([N, K] x2)."""
        Kxz = self.kernel.K(Xnew, self.Z)                      # [N, M]
        Kdiag = self.kernel.K_diag(Xnew)                       # [N]
        fmean = Kxz @ self.alpha                               # [N, K]
        At = Kxz @ self.Linv.T                                 # [N, M] = A^T
        quad = (At[None] @ self.S).square().sum(-1).T          # [N, K]
        fvar = ((Kdiag - At.square().sum(-1))[:, None] + quad).clamp_min(1e-12)
        return fmean, expand_independent_outputs(fvar, False, full_output_cov)


def precompute_posterior(svgp) -> PrecomputedPosterior:
    """Fold an SVGP's variational state into a PrecomputedPosterior."""
    Linv = triangular_inverse(cholesky(svgp.kuu()))            # [M, M]
    q_mu, q_sqrt = svgp.q_mu.value, svgp.q_sqrt.value
    if q_sqrt.ndim == 2:                                       # diag std-devs
        S = torch.diag_embed(q_sqrt.T)                         # [K, M, M]
    else:
        S = torch.tril(q_sqrt)
    if not svgp.whiten:
        q_mu = Linv @ q_mu
        S = Linv @ S
    return PrecomputedPosterior(svgp.kernel, svgp.Z.value, Linv.T @ q_mu,
                                Linv, S)


def precompute_smgp(model):
    """The same SMGP with both layers folded into cached posteriors.

    It serves predict_y, predict_assign and predict_density with no Cholesky
    or solves per batch.  Re-precompute after any parameter update.
    """
    from .smgp import SMGP
    return SMGP(model.likelihood, precompute_posterior(model.pred_layer),
                precompute_posterior(model.assign_layer), K=model.K,
                num_samples=model.num_samples, num_data=model.num_data,
                temperature=model.temperature)
