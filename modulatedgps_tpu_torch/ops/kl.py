"""KL[q(u) || N(0, I)] of a whitened SVGP layer.

Mirrors modulatedgps_tpu/ops/kl.py:49-126,129-187 for ``Kmm=None`` (the
whitened prior), which is what the models train: the closed form

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
"""
from __future__ import annotations

import torch

from .kl_kernel import kl_bwd_scale, kl_sq_logdiag

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
        return _tril_value(q_mu, Lq, routed)

    @staticmethod
    def backward(ctx, g):
        q_mu, Lq = ctx.saved_tensors
        if ctx.routed:
            dLq = kl_bwd_scale(Lq, g.reshape(()).contiguous())
        else:
            dLq = g * Lq
            dLq.diagonal(dim1=-2, dim2=-1).sub_(
                g / torch.diagonal(Lq, dim1=-2, dim2=-1))
        return g * q_mu, dLq, None


def gauss_kl(q_mu: torch.Tensor, q_sqrt: torch.Tensor, *,
             assume_tril: bool = False) -> torch.Tensor:
    """KL[q(u) || N(0, I)] summed over the K latent GPs: q_mu [M, K];
    q_sqrt [K, M, M] or [M, K] diagonal std-devs.

    A rank-3 q_sqrt is read through torch.tril unless ``assume_tril``
    promises it is lower-triangular already, as in JAX."""
    M, K = q_mu.shape
    if q_sqrt.ndim == 3:
        Lq = q_sqrt if assume_tril else torch.tril(q_sqrt)
        routed = assume_tril and Lq.dtype == torch.float32
        return _WhitenedTrilKL.apply(q_mu, Lq, routed)
    if q_sqrt.ndim != 2:
        raise ValueError(f"q_sqrt must be rank 2 or 3, got {q_sqrt.ndim}")
    return 0.5 * (q_mu.square().sum() - M * K
                  - 2.0 * torch.log(q_sqrt).sum() + q_sqrt.square().sum())
