"""KL[q(u) || p(u)] of an SVGP layer, whitened (p = N(0, I)) or not
(p = N(0, Kmm)).

Mirrors modulatedgps_tpu/ops/kl.py:49-126,129-187.  For ``Kmm=None`` (the
whitened prior) the closed form

    KL = 0.5 (|q_mu|^2 - M K - log det(S S^T) + tr(S S^T)),

for a lower-triangular q_sqrt [K, M, M] or diagonal std-devs [M, K].  The
tril form is an autograd Function with the JAX package's analytic backward
(``_dense_kl_bwd``): d/dq_mu = g q_mu, d/dLq = g (Lq - diag(1/diag Lq)), one
elementwise pass instead of autodiff's diagonal scatter.

A float32 q_sqrt with ``assume_tril=True`` (a "tril" Parameter's value, as
``SVGP.prior_kl`` passes it) takes both q_sqrt terms from the tril kernels
of kl_kernel.py: ``kl_sq_logdiag`` forward, ``kl_bwd_scale`` backward (the
CUDA kernels on the card, their plain versions on the CPU).  float64 and
``assume_tril=False`` keep the dense form, which is also their oracle.

With the prior covariance Kmm (an unwhitened layer), L = chol(Kmm) and

    KL = 0.5 (|L^-1 q_mu|^2 - M K - log det(S S^T) + tr(Kmm^-1 S S^T)
              + K log det Kmm),

the trace taken as |L^-1 S|^2, one solve with a [M, K*M] right side (the
diagonal of Kmm^-1 for a diagonal q_sqrt); both right sides are
lower-triangular in each latent's M columns, so the solve skips their zero
rows (``tril_rhs``).  Its gradients go through the
solve's and the Cholesky's autograd Functions (ops/linalg.py); #12/#13
serve the whitened form only, as in JAX.
"""
from __future__ import annotations

import torch

from ..utils.profiling import span
from .kl_kernel import kl_bwd_scale, kl_sq_logdiag
from .linalg import cholesky_with_inv, solve_lower

__all__ = ["gauss_kl"]


def _tril_value(q_mu, Lq, routed):
    M, K = q_mu.shape
    if routed:
        sumsq, logdiag = kl_sq_logdiag(Lq)
    else:
        logdiag = torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1).abs()).sum()
        sumsq = Lq.square().sum()
    return 0.5 * (q_mu.square().sum() - M * K - 2.0 * logdiag + sumsq)


class _WhitenedTrilKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_mu, Lq, routed):
        ctx.routed = routed
        ctx.save_for_backward(q_mu, Lq)
        with span("mgp.kl.fwd", Lq, "op"):
            return _tril_value(q_mu, Lq, routed)

    @staticmethod
    def backward(ctx, g):
        q_mu, Lq = ctx.saved_tensors
        with span("mgp.kl.bwd", g, "op"):
            if ctx.routed:
                dLq = kl_bwd_scale(Lq, g.reshape(()).contiguous())
            else:
                dLq = g * Lq
                dLq.diagonal(dim1=-2, dim2=-1).sub_(
                    g / torch.diagonal(Lq, dim1=-2, dim2=-1))
            return g * q_mu, dLq, None


def gauss_kl(q_mu: torch.Tensor, q_sqrt: torch.Tensor,
             Kmm: torch.Tensor | None = None, *,
             assume_tril: bool = False) -> torch.Tensor:
    """KL[q(u) || p(u)] summed over the K latent GPs: q_mu [M, K];
    q_sqrt [K, M, M] or [M, K] diagonal std-devs; Kmm [M, M] the prior
    covariance, or None for the whitened prior N(0, I).

    A rank-3 q_sqrt is read through torch.tril unless ``assume_tril``
    promises it is lower-triangular already, as in JAX."""
    M, K = q_mu.shape
    if q_sqrt.ndim not in (2, 3):
        raise ValueError(f"q_sqrt must be rank 2 or 3, got {q_sqrt.ndim}")
    Lq = None
    if q_sqrt.ndim == 3:
        Lq = q_sqrt if assume_tril else torch.tril(q_sqrt)
    if Kmm is None:
        if Lq is not None:
            routed = assume_tril and Lq.dtype == torch.float32
            return _WhitenedTrilKL.apply(q_mu, Lq, routed)
        return 0.5 * (q_mu.square().sum() - M * K
                      - 2.0 * torch.log(q_sqrt).sum() + q_sqrt.square().sum())
    Lp, inv = cholesky_with_inv(Kmm)
    mahalanobis = solve_lower(Lp, q_mu, inv=inv).square().sum()
    if Lq is None:
        logdet_q = 2.0 * torch.log(q_sqrt).sum()
        eye = torch.eye(M, dtype=Kmm.dtype, device=Kmm.device)
        Kinv_diag = solve_lower(Lp, eye, inv=inv,
                                tril_rhs=True).square().sum(0)  # diag Kmm^-1
        trace = (Kinv_diag[:, None] * q_sqrt.square()).sum()
    else:
        logdet_q = 2.0 * torch.log(
            torch.diagonal(Lq, dim1=-2, dim2=-1).abs()).sum()
        trace = solve_lower(Lp, Lq, inv=inv, tril_rhs=True).square().sum()
    logdet_p = 2.0 * torch.log(torch.diagonal(Lp)).sum()
    return 0.5 * (mahalanobis - M * K - logdet_q + trace + K * logdet_p)
