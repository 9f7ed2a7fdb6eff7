"""Sparse-GP conditional: Cholesky, triangular inverse, matmuls.

Mirrors modulatedgps_tpu/ops/conditionals.py for the serving slice:
``base_conditional`` with white=True and full_cov=False, for a
lower-triangular [K, M, M], diagonal [M, K] or absent q_sqrt:

    A     = chol(Kmm)^-1 Kmn                  [M, N]
    fmean = A^T q_mu                          [N, K]
    fvar  = Knn - sum_m A^2 + sum_m' (A^T tril q_sqrt_k)^2     [N, K]

For a float32 tril q_sqrt the last term goes through the bf16 tril kernels
(tril_kernel.atl_sq_colsum, forward and backward), the precision class of
the TPU path; its bf16 B puts ~0.4% relative error into that term, so fvar
is clamped at 1e-12 as in JAX.  float64 (the CPU reference) forms B densely
in float64.  Gradients flow through both routes and through whiten_solve.
"""
from __future__ import annotations

import torch

from .linalg import whiten_solve
from .tril_kernel import atl_sq_colsum

__all__ = ["base_conditional", "expand_independent_outputs"]


def expand_independent_outputs(fvar: torch.Tensor, full_cov: bool,
                               full_output_cov: bool) -> torch.Tensor:
    """gpflow expand_independent_outputs: the K latents are independent, so
    the full-output covariance is diagonal over the output axis.

      full_cov, full_output_cov:  [K, N, N] -> [N, K, N, K]
      diag,     full_output_cov:  [N, K]    -> [N, K, K]
      otherwise unchanged.
    """
    if not full_output_cov:
        return fvar
    if full_cov:
        d = torch.movedim(fvar, 0, -1)                         # [N, N, K]
        eye = torch.eye(d.shape[-1], dtype=fvar.dtype, device=fvar.device)
        return (d[..., :, None] * eye).permute(0, 2, 1, 3)
    eye = torch.eye(fvar.shape[-1], dtype=fvar.dtype, device=fvar.device)
    return fvar[..., :, None] * eye


def base_conditional(Kmn, Kmm, Knn, q_mu, *, q_sqrt=None,
                     full_cov: bool = False, white: bool = True):
    """Marginal q(f) = N(fmean, fvar) of a whitened SVGP: ([N, K], [N, K]).

    Kmn [M, N], Kmm [M, M], Knn [N] (the diagonal), q_mu [M, K].
    """
    if not white or full_cov:
        raise NotImplementedError(
            "the port serves white=True, full_cov=False; the other "
            "conditionals wait for later slices")
    A = whiten_solve(Kmm, Kmn)                                 # [M, N]
    fvar = Knn - A.square().sum(-2)                            # [N]
    fmean = A.T @ q_mu                                         # [N, K]
    K = q_mu.shape[-1]
    if q_sqrt is None:
        return fmean, fvar[:, None].expand(-1, K)
    if q_sqrt.ndim == 2:                                       # diag [M, K]
        B = q_sqrt.T[:, None, :] * A.T[None]                   # [K, N, M]
        extra = B.square().sum(-1)
    elif q_sqrt.ndim == 3:                                     # tril [K, M, M]
        if A.dtype == torch.float32:
            extra = atl_sq_colsum(A, q_sqrt)                   # [K, N]
            fvar = (fvar[None, :] + extra).clamp_min(1e-12)
            return fmean, fvar.T
        extra = (A.T[None] @ torch.tril(q_sqrt)).square().sum(-1)
    else:
        raise ValueError(f"q_sqrt must be rank 2 or 3, got {q_sqrt.ndim}")
    return fmean, (fvar[None, :] + extra).T
