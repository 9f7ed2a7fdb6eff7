"""Precomputed SVGP posterior: the serving path.

Mirrors modulatedgps_tpu/models/posterior.py.  All X-independent algebra
is done once per parameter update, so a prediction batch costs one kernel
build, two matmuls and the q_sqrt term, with no Cholesky or solves:

    fmean  = Kxz @ alpha,                  alpha = L^-T q_mu          [M, K]
    fvar_k = Kdiag + |S_k^T a|^2 - |a|^2,  a = L^-1 k(Z, x)           [M]

for a whitened layer, S = tril q_sqrt.  An unwhitened layer caches
alpha = L^-T (L^-1 q_mu) = Kmm^-1 q_mu and S_k = L^-1 tril q_sqrt_k (the
JAX package's ``LS``, a plain matmul of two lower-triangular factors) and
serves the same formula.  The q_sqrt term of a float32 posterior is one
launch of the fused kernel qsqrt_sq_colsum on the cached bf16 S and
bf16(A), A = L^-1 K(Z, X) [M, N].

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
from ..ops.linalg import cholesky_with_inv, triangular_inverse
from ..ops.quad_kernel import qsqrt_sq_colsum

__all__ = ["PrecomputedPosterior", "precompute_posterior", "precompute_smgp"]


class PrecomputedPosterior(nn.Module):
    """The cached factors of one layer.  A float32 posterior keeps S only as
    S16 = bf16(S), cast once here, and takes |S_k^T a|^2 from the fused
    kernel qsqrt_sq_colsum (bf16 operands, fp32 accumulation: the precision
    class of the TPU's served route, an f32 einsum at DEFAULT precision);
    float64 (the CPU reference) keeps S and the dense form."""

    def __init__(self, kernel: Kernel, Z: torch.Tensor, alpha: torch.Tensor,
                 Linv: torch.Tensor, S: torch.Tensor):
        super().__init__()
        self.kernel = kernel
        self.register_buffer("Z", Z)            # [M, D]
        self.register_buffer("alpha", alpha)    # [M, K]
        self.register_buffer("Linv", Linv)      # [M, M] lower
        f32 = S.dtype == torch.float32
        # [K, M, M] lower, one of the two
        self.register_buffer("S", None if f32 else S)
        self.register_buffer("S16", S.to(torch.bfloat16) if f32 else None)

    def predict_f(self, Xnew: torch.Tensor, *, full_output_cov: bool = False):
        """Marginal posterior mean and variance at Xnew [N, D]: ([N, K] x2)."""
        Kzx = self.kernel.K(self.Z, Xnew)                      # [M, N]
        Kdiag = self.kernel.K_diag(Xnew)                       # [N]
        fmean = Kzx.T @ self.alpha                             # [N, K]
        A = self.Linv @ Kzx                                    # [M, N]
        if self.S16 is not None:
            quad = qsqrt_sq_colsum(self.S16, A)                # [K, N]
        else:
            quad = (self.S.transpose(-1, -2) @ A).square().sum(-2)
        fvar = ((Kdiag - A.square().sum(0))[None, :] + quad).clamp_min(1e-12)
        return fmean, expand_independent_outputs(fvar.T, False, full_output_cov)


def precompute_posterior(svgp) -> PrecomputedPosterior:
    """Fold an SVGP's variational state into a PrecomputedPosterior."""
    Linv = triangular_inverse(*cholesky_with_inv(svgp.kuu()))  # [M, M]
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
