"""MultiClass likelihood with the RobustMax inverse link.

Mirrors modulatedgps_tpu/likelihoods/multiclass.py (gpflow's MultiClass and
RobustMax).  The expected log-likelihood is

    E[log p(y | f)] = p log(1 - eps) + (1 - p) log(eps / (K - 1))

with p = P(f_y is the largest latent), by 1-D Gauss-Hermite quadrature over
the selected latent crossed with the normal CDFs of the others, all classes
at once over a [..., N, K, P] grid.

Shapes: Fmu, Fvar [..., N, K]; Y [N, 1] labels (integer or float holding
integers).  ``variational_expectations`` returns [..., N, 1].

The product over the K classes takes JAX's gradient: the pullback of each
factor is the product of the other factors (prefix and suffix cumulative
products), not torch.prod's product divided by the factor.  The CDFs are
squeezed into [1e-4, 1 - 1e-4], so the K - 1 factors of a product reach
1e-4^(K-1): below float32's smallest normal (1.2e-38) from K = 11 on, where
the division loses every digit of the partial product.  (torch.prod's
pullback also reads a count of zero factors back to the host.)
"""
from __future__ import annotations

import numpy as np
import torch
from torch.nn.functional import one_hot

from ..ops.quadrature import DEFAULT_NUM_POINTS, gauss_hermite_points, sqrt_const
from .base import Likelihood

__all__ = ["MultiClass", "RobustMax", "prod_exclusive_grad"]


class _Prod(torch.autograd.Function):
    """torch.prod over ``dim`` with the pullback g * prod_{j != i} x_j."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.save_for_backward(x)
        ctx.dim = dim
        return torch.prod(x, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        x, = ctx.saved_tensors
        dim = ctx.dim
        n = x.shape[dim]
        ones = torch.ones_like(x.narrow(dim, 0, 1))
        before = torch.cat([ones, x.narrow(dim, 0, n - 1).cumprod(dim)], dim)
        after = torch.cat([x.narrow(dim, 1, n - 1).flip(dim).cumprod(dim)
                           .flip(dim), ones], dim)
        return grad.unsqueeze(dim) * before * after, None


def prod_exclusive_grad(x: torch.Tensor, dim: int) -> torch.Tensor:
    """torch.prod(x, dim) whose gradient is the product of the other factors
    (jax.lax.reduce_prod's)."""
    if x.shape[dim] < 2:
        return torch.prod(x, dim=dim)
    return _Prod.apply(x, dim % x.ndim)


def _labels(Y: torch.Tensor) -> torch.Tensor:
    """Integer labels from Y [..., N, 1] (or [..., N])."""
    return (Y[..., 0] if Y.shape[-1] == 1 else Y).to(torch.int64)


class RobustMax(Likelihood):
    """P(y = c | f) = 1 - eps if f_c is the largest latent, else eps/(K-1)."""

    def __init__(self, num_classes: int = 2, epsilon: float = 1e-3):
        super().__init__()
        self.num_classes = num_classes
        self.epsilon = epsilon

    @property
    def eps_k1(self) -> float:
        return self.epsilon / (self.num_classes - 1.0)

    def prob_is_largest(self, Y, Fmu, Fvar,
                        num_points: int = DEFAULT_NUM_POINTS):
        """P(f_c > f_j for all j != c), c = Y, under independent
        N(Fmu, Fvar): int N(x; mu_c, var_c) prod_{j != c} Phi((x - mu_j) /
        sigma_j) dx, [..., N]."""
        dtype = Fmu.dtype
        gh_x, gh_w = gauss_hermite_points(num_points, dtype, Fmu.device)
        oh_on = one_hot(_labels(Y), self.num_classes).to(dtype)  # [N, K]
        oh_off = 1.0 - oh_on

        mu_sel = (oh_on * Fmu).sum(-1)                             # [..., N]
        var_sel = (oh_on * Fvar).sum(-1)
        # the quadrature grid on the selected latent: [..., N, P]
        X = mu_sel[..., None] + gh_x * torch.sqrt(
            (2.0 * var_sel).clamp_min(1e-10))[..., None]
        # every latent's CDF at every grid point: [..., N, K, P]
        dist = (X[..., None, :] - Fmu[..., None]) / torch.sqrt(
            Fvar.clamp_min(1e-10))[..., None]
        cdfs = 0.5 * (1.0 + torch.erf(dist / sqrt_const(2.0, dtype)))
        cdfs = cdfs * (1 - 2e-4) + 1e-4
        # blank the selected latent's own CDF out of the product
        cdfs = cdfs * oh_off[..., None] + oh_on[..., None]

        w = gh_w / sqrt_const(np.pi, dtype)
        return (prod_exclusive_grad(cdfs, -2) * w).sum(-1)        # [..., N]


class MultiClass(Likelihood):
    def __init__(self, num_classes: int = 2, invlink: RobustMax | None = None,
                 num_gauss_hermite_points: int = DEFAULT_NUM_POINTS):
        super().__init__()
        self.num_classes = num_classes
        self.invlink = invlink
        self.num_gauss_hermite_points = num_gauss_hermite_points

    @classmethod
    def create(cls, num_classes: int, invlink: RobustMax | None = None,
               num_gauss_hermite_points: int = DEFAULT_NUM_POINTS
               ) -> "MultiClass":
        if invlink is None:
            invlink = RobustMax(num_classes=num_classes)
        return cls(num_classes, invlink, num_gauss_hermite_points)

    def _prob(self, Y, Fmu, Fvar):
        return self.invlink.prob_is_largest(Y, Fmu, Fvar,
                                            self.num_gauss_hermite_points)

    def log_prob(self, F, Y):
        """log(1 - eps) where F's argmax is the label, else
        log(eps / (K - 1)): [..., N, 1]."""
        hits = torch.argmax(F, dim=-1) == _labels(Y)
        yes = F.new_full((), 1.0 - self.invlink.epsilon)
        no = F.new_full((), self.invlink.eps_k1)
        return torch.log(torch.where(hits, yes, no))[..., None]

    def variational_expectations(self, Fmu, Fvar, Y):
        p = self._prob(Y, Fmu, Fvar)
        ve = (p * float(np.log(1.0 - self.invlink.epsilon))
              + (1.0 - p) * float(np.log(self.invlink.eps_k1)))
        return ve[..., None]                                      # [..., N, 1]

    def predict_mean_and_var(self, Fmu, Fvar):
        """Expected class probabilities under RobustMax, [..., N, K]: for
        each class c, (1 - eps) P(f_c max) + eps/(K-1) (1 - P(f_c max)).
        One quadrature per class, as the JAX package unrolls it."""
        eps, eps_k1 = self.invlink.epsilon, self.invlink.eps_k1
        ps = []
        for c in range(self.num_classes):
            Yc = torch.full((*Fmu.shape[:-1], 1), c, dtype=torch.int64,
                            device=Fmu.device)
            p = self._prob(Yc, Fmu, Fvar)
            ps.append(p * (1.0 - eps) + (1.0 - p) * eps_k1)
        mean = torch.stack(ps, dim=-1)
        return mean, mean - mean.square()

    def predict_log_density(self, Fmu, Fvar, Y):
        p = self._prob(Y, Fmu, Fvar)
        eps = self.invlink.epsilon
        return torch.log(p * (1.0 - eps) + (1.0 - p) * self.invlink.eps_k1)
