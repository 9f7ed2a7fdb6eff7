"""Variational GP with a non-sparse posterior over the training inputs.

Mirrors modulatedgps_tpu/models/vgp.py:30-116 (gpflow's VGP, whitened):
q(v) = N(q_mu, q_sqrt q_sqrt^T) lives at the N training inputs in whitened
space, f = L v with L = chol(K(X, X) + jitter I).  There are no inducing
points.

The training-point marginals need no solve: fmean = L q_mu and fvar =
rowsum((L q_sqrt)^2) are two matmuls, left to torch.matmul as JAX leaves
them to XLA (TF32 is off in the whole package).  The N x N Cholesky runs
the blocked kernel #15/#16 with Murray's pullback (#2's inverse, #10/#11);
K(X, X) and K(X, Xnew) run #1 and its pullback; the whitened tril KL runs
#12/#13 for a float32 q_sqrt; ``predict_f`` goes through the whitened
conditional: #2's inverse, then #3 for the marginals or #5 with
``full_cov``.  ``create`` puts the state on the card unless given a device.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import default_float, default_jitter
from ..likelihoods.base import Likelihood
from ..ops.conditionals import base_conditional
from ..ops.kernels import Kernel
from ..ops.kl import gauss_kl
from ..ops.linalg import add_jitter, cholesky
from ..params import Parameter

__all__ = ["VGP"]


class VGP(nn.Module):
    """X [N, D] and Y [N, P] are non-trainable Parameters (the JAX leaves
    ``X.raw`` and ``Y.raw``); q_mu [N, K]; q_sqrt tril [K, N, N]."""

    def __init__(self, kernel: Kernel, likelihood: Likelihood, X: Parameter,
                 Y: Parameter, q_mu: Parameter, q_sqrt: Parameter, *,
                 mean_function: nn.Module | None = None):
        super().__init__()
        self.kernel = kernel
        self.likelihood = likelihood
        self.X = X
        self.Y = Y
        self.q_mu = q_mu
        self.q_sqrt = q_sqrt
        self.mean_function = mean_function    # None = Zero
        self.num_latent = q_mu.shape[-1]

    @classmethod
    def create(cls, kernel: Kernel, likelihood: Likelihood, X, Y,
               num_latent_gps: int | None = None,
               mean_function: nn.Module | None = None,
               dtype: torch.dtype | None = None,
               device: torch.device | str = "cuda") -> "VGP":
        """gpflow's VGP.__init__: q_mu = zeros(N, K), q_sqrt = K stacked
        identities under the tril transform."""
        dtype = dtype or default_float()
        X = torch.as_tensor(X, dtype=dtype, device=device)
        Y = torch.as_tensor(Y, dtype=dtype, device=device)
        N = X.shape[0]
        K = num_latent_gps if num_latent_gps is not None else Y.shape[-1]
        q_mu = torch.zeros((N, K), dtype=dtype, device=device)
        eye = torch.eye(N, dtype=dtype, device=device)
        return cls(kernel, likelihood, Parameter(X, trainable=False),
                   Parameter(Y, trainable=False), Parameter(q_mu),
                   Parameter(eye.expand(K, N, N).clone(), "tril"),
                   mean_function=mean_function)

    @property
    def num_data(self) -> int:
        return self.X.shape[0]

    def _kxx(self) -> torch.Tensor:
        X = self.X.value
        return add_jitter(self.kernel.K(X), default_jitter(X.dtype))

    def q_moments(self):
        """The marginal q(f) at the training points: fmean = L q_mu [N, K],
        fvar_n = sum_m (L q_sqrt)_{nm}^2 [N, K]; matmuls only."""
        L = cholesky(self._kxx())                              # [N, N]
        fmean = L @ self.q_mu.value
        if self.mean_function is not None:
            fmean = fmean + self.mean_function(self.X.value)
        LS = L[None] @ self.q_sqrt.value                       # [K, N, N]
        return fmean, LS.square().sum(-1).T

    def prior_kl(self) -> torch.Tensor:
        """Whitened KL[q(v) || N(0, I)]."""
        return gauss_kl(self.q_mu.value, self.q_sqrt.value, None,
                        assume_tril=self.q_sqrt.transform == "tril")

    def elbo(self) -> torch.Tensor:
        fmean, fvar = self.q_moments()
        ve = self.likelihood.variational_expectations(fmean, fvar, self.Y.value)
        return ve.sum() - self.prior_kl()

    def training_loss(self, generator=None, X=None, Y=None) -> torch.Tensor:
        """The negative ELBO.  ``generator``, X and Y are accepted and
        ignored, so run_adam's step drives a VGP too: the model owns its
        data (gpflow's InternalDataTrainingLossMixin)."""
        return -self.elbo()

    def predict_f(self, Xnew: torch.Tensor, *, full_cov: bool = False):
        """q(f(Xnew)) through the whitened conditional (Kmm = K(X, X) +
        jitter I): the mean [N*, K] and the marginal variances [N*, K], or
        the covariance [K, N*, N*] with ``full_cov``.  It agrees with
        ``q_moments`` at the training points only to ~sqrt(jitter): the
        conditional's Kmm carries the jitter, its Kmn does not."""
        Kmn = self.kernel.K(self.X.value, Xnew)
        Knn = self.kernel(Xnew, full_cov=full_cov)
        fmean, fvar = base_conditional(Kmn, self._kxx(), Knn, self.q_mu.value,
                                       q_sqrt=self.q_sqrt.value,
                                       full_cov=full_cov, white=True)
        if self.mean_function is not None:
            fmean = fmean + self.mean_function(Xnew)
        return fmean, fvar

    def predict_y(self, Xnew: torch.Tensor):
        fmean, fvar = self.predict_f(Xnew)
        return self.likelihood.predict_mean_and_var(fmean, fvar)

    def predict_log_density(self, Xnew: torch.Tensor, Ynew: torch.Tensor):
        fmean, fvar = self.predict_f(Xnew)
        return self.likelihood.predict_log_density(fmean, fvar, Ynew)
