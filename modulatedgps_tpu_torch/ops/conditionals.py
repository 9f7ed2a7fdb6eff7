"""Sparse-GP conditional: Cholesky, triangular solves, matmuls.

Mirrors modulatedgps_tpu/ops/conditionals.py: ``base_conditional``,
``conditional_from_chol`` and ``sgp_conditional`` (the kernel build and the
conditional of one layer), whitened or not, for a lower-triangular
[K, M, M], diagonal [M, K] or absent q_sqrt, marginal (full_cov=False) or
joint over the N points (full_cov=True):

    A     = chol(Kmm)^-1 Kmn                  [M, N]
    fvar  = Knn - sum_m A^2                   [N]          (marginal)
    fvar  = Knn - A^T A                       [N, N]       (joint)
    A     = chol(Kmm)^-T A                    (white=False only)
    fmean = A^T q_mu                          [N, K]
    B_k   = A^T tril q_sqrt_k                 [K, N, M]
    fvar += sum_m' B^2  or  B_k B_k^T

The whitened A comes from whiten_solve (one TRSM inverse and a matmul);
the unwhitened one from two exact solves (solve_lower: the forward and the
transposed TRSM kernels).  For a float32 tril q_sqrt, B goes through the
bf16 tril kernels, the precision class of the TPU path: the marginal
through tril_kernel.atl_sq_colsum (B held in bf16; its ~0.4% relative error
in the q_sqrt term is why fvar is clamped at 1e-12 as in JAX; ``split``
takes B in f32 from three bf16 passes instead, as the SMGP's layers do),
the joint
through tril_kernel.atl_matmul (f32 B from bf16 operands).  The two [N, N]
products of the joint form stay fp32 matmuls, as JAX leaves them to XLA.
float64 (the CPU reference) forms B densely in float64.  Every route is
differentiable.
"""
from __future__ import annotations

import torch

from .linalg import cholesky_with_inv, solve_lower, whiten_solve
from .tril_kernel import atl_matmul, atl_sq_colsum

__all__ = ["base_conditional", "conditional_from_chol",
           "expand_independent_outputs", "sgp_conditional"]


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
                     full_cov: bool = False, white: bool = True,
                     split: bool = False):
    """q(f) = N(fmean, fvar) of an SVGP: fmean [N, K] and fvar [N, K]
    (full_cov=False) or [K, N, N] (full_cov=True).

    Kmn [M, N], Kmm [M, M], Knn [N] (the diagonal) or [N, N] (full_cov),
    q_mu [M, K].  ``split`` takes a float32 tril q_sqrt's marginal variance
    term by three bf16 passes (tril_kernel.atl_sq_colsum).
    """
    if white:
        return _conditional_tail(whiten_solve(Kmm, Kmn), None, Knn, q_mu,
                                 q_sqrt=q_sqrt, full_cov=full_cov, white=True,
                                 split=split)
    Lm, inv = cholesky_with_inv(Kmm)
    return conditional_from_chol(Kmn, Lm, Knn, q_mu, q_sqrt=q_sqrt,
                                 full_cov=full_cov, white=False, inv=inv,
                                 split=split)


def conditional_from_chol(Kmn, Lm, Knn, q_mu, *, q_sqrt=None,
                          full_cov: bool = False, white: bool = True,
                          inv=None, split: bool = False):
    """base_conditional with the Cholesky factor Lm of Kmm given (and
    ``inv``, the inverses of its diagonal blocks, if the caller has them)."""
    return _conditional_tail(solve_lower(Lm, Kmn, inv=inv), Lm, Knn, q_mu,
                             q_sqrt=q_sqrt, full_cov=full_cov, white=white,
                             inv=inv, split=split)


def _conditional_tail(A, Lm, Knn, q_mu, *, q_sqrt, full_cov, white, inv=None,
                      split=False):
    """Everything downstream of the whitened feature map A = Lm^-1 Kmn; Lm
    (and inv) are read only for the unwhitened second solve."""
    if full_cov:
        fvar = Knn - A.T @ A                                   # [N, N]
    else:
        fvar = Knn - A.square().sum(-2)                        # [N]
    if not white:
        A = solve_lower(Lm, A, trans=True, inv=inv)            # Lm^-T A
    fmean = A.T @ q_mu                                         # [N, K]
    K = q_mu.shape[-1]
    if q_sqrt is None:
        return fmean, (fvar.expand(K, *fvar.shape) if full_cov
                       else fvar[:, None].expand(-1, K))
    if q_sqrt.ndim == 2:                                       # diag [M, K]
        B = q_sqrt.T[:, None, :] * A.T[None]                   # [K, N, M]
    elif q_sqrt.ndim == 3:                                     # tril [K, M, M]
        if A.dtype == torch.float32 and not full_cov:
            extra = atl_sq_colsum(A, q_sqrt, split)            # [K, N]
            fvar = (fvar[None, :] + extra).clamp_min(1e-12)
            return fmean, fvar.T
        if A.dtype == torch.float32:
            B = atl_matmul(A, q_sqrt)                          # [K, N, M] f32
        else:
            B = A.T[None] @ torch.tril(q_sqrt)
    else:
        raise ValueError(f"q_sqrt must be rank 2 or 3, got {q_sqrt.ndim}")
    if full_cov:
        return fmean, fvar[None] + B @ B.transpose(-1, -2)     # [K, N, N]
    return fmean, (fvar[None, :] + B.square().sum(-1)).T


def sgp_conditional(kernel, Z, Xnew, q_mu, q_sqrt, *, jitter: float,
                    full_cov: bool = False, white: bool = True):
    """One SVGP layer's conditional from its kernel: Kmm = K(Z, Z) +
    jitter I, Kmn = K(Z, Xnew), Knn = K(Xnew) (its diagonal unless
    ``full_cov``), then base_conditional."""
    Kmm = kernel.K(Z) + jitter * torch.eye(Z.shape[-2], dtype=Z.dtype,
                                           device=Z.device)
    Kmn = kernel.K(Z, Xnew)
    Knn = kernel(Xnew, full_cov=full_cov)
    return base_conditional(Kmn, Kmm, Knn, q_mu, q_sqrt=q_sqrt,
                            full_cov=full_cov, white=white)
