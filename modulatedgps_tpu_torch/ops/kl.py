"""KL[q(u) || N(0, I)] of a whitened SVGP layer.

Mirrors modulatedgps_tpu/ops/kl.py:49-102,129-187 for ``Kmm=None`` (the
whitened prior), which is what the models train: the closed form

    KL = 0.5 (|q_mu|^2 - M K - log det(S S^T) + tr(S S^T)),

for a lower-triangular q_sqrt [K, M, M] or diagonal std-devs [M, K].  The
tril form is an autograd Function with the JAX package's analytic backward
(``_dense_kl_bwd``): d/dq_mu = g q_mu, d/dLq = g (Lq - diag(1/diag Lq)), one
elementwise pass instead of autodiff's diagonal scatter.  It is dense torch
on this slice; the tril-block kernels (pallas_kl.py) come with a later one.
"""
from __future__ import annotations

import torch

__all__ = ["gauss_kl"]


def _tril_value(q_mu, Lq):
    M, K = q_mu.shape
    logdet = 2.0 * torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1).abs()).sum()
    return 0.5 * (q_mu.square().sum() - M * K - logdet + Lq.square().sum())


class _WhitenedTrilKL(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q_mu, Lq):
        ctx.save_for_backward(q_mu, Lq)
        return _tril_value(q_mu, Lq)

    @staticmethod
    def backward(ctx, g):
        q_mu, Lq = ctx.saved_tensors
        dLq = g * Lq
        dLq.diagonal(dim1=-2, dim2=-1).sub_(
            g / torch.diagonal(Lq, dim1=-2, dim2=-1))
        return g * q_mu, dLq


def gauss_kl(q_mu: torch.Tensor, q_sqrt: torch.Tensor) -> torch.Tensor:
    """KL[q(u) || N(0, I)] summed over the K latent GPs: q_mu [M, K];
    q_sqrt [K, M, M] lower-triangular (read as given, as the "tril"
    Parameter's value is) or [M, K] diagonal std-devs."""
    M, K = q_mu.shape
    if q_sqrt.ndim == 3:
        return _WhitenedTrilKL.apply(q_mu, q_sqrt)
    if q_sqrt.ndim != 2:
        raise ValueError(f"q_sqrt must be rank 2 or 3, got {q_sqrt.ndim}")
    return 0.5 * (q_mu.square().sum() - M * K
                  - 2.0 * torch.log(q_sqrt).sum() + q_sqrt.square().sum())
