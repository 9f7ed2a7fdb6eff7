"""Sparse variational GP layer (inducing points, whitened or not).

Mirrors modulatedgps_tpu/models/svgp.py: ``create``, ``num_inducing``,
``kuu``, ``predict_f`` (marginal or joint, over [..., N, D] inputs, plus
the mean function if there is one), ``predict_mean``,
``predict_f_samples`` and ``prior_kl``.  Kmn is built as kernel.K(Z,
Xnew) and Kmm = K(Z, Z) + jitter I.  State: Z [M, D], q_mu [M, K],
q_sqrt tril [K, M, M] (init: K stacked identities) or diagonal [M, K];
with ``whiten`` (the default) q(u) is over the whitened u' =
chol(Kmm)^-1 u, without it over u itself.
``create`` puts the state on the card unless given a device.
"""
from __future__ import annotations

import torch
from torch import nn

from ..config import default_float, default_jitter
from ..ops.conditionals import base_conditional, expand_independent_outputs
from ..ops.kernels import Kernel
from ..ops.kl import gauss_kl
from ..ops.linalg import add_jitter
from ..ops.linalg import cholesky_nan as _cholesky_nan
from ..params import Parameter
from ..utils.shapes import ShapeChecker

__all__ = ["SVGP"]


class SVGP(nn.Module):
    def __init__(self, kernel: Kernel, Z: Parameter, q_mu: Parameter,
                 q_sqrt: Parameter, *, mean_function: nn.Module | None = None,
                 whiten: bool = True, jitter: float | None = None):
        super().__init__()
        self.kernel = kernel
        self.Z = Z
        self.q_mu = q_mu
        self.q_sqrt = q_sqrt
        # None = Zero: no add (ops/mean_functions.py)
        self.mean_function = mean_function
        self.whiten = whiten
        # None = default_jitter(dtype).  A whitened model must be evaluated
        # at the jitter it was trained with, whatever dtype serves it.
        self.jitter = jitter

    @classmethod
    def create(cls, kernel: Kernel, inducing_points, num_latent_gps: int = 1,
               *, whiten: bool = True, q_diag: bool = False,
               mean_function: nn.Module | None = None,
               jitter: float | None = None,
               dtype: torch.dtype | None = None,
               device: torch.device | str = "cuda") -> "SVGP":
        dtype = dtype or default_float()
        Z = torch.as_tensor(inducing_points, dtype=dtype, device=device)
        M, K = Z.shape[0], num_latent_gps
        q_mu = torch.zeros((M, K), dtype=dtype, device=device)
        if q_diag:
            q_sqrt = Parameter.from_value(torch.ones((M, K)), "positive",
                                          dtype=dtype, device=device)
        else:
            eye = torch.eye(M, dtype=dtype, device=device)
            q_sqrt = Parameter(eye.expand(K, M, M).clone(), "tril")
        return cls(kernel, Parameter(Z), Parameter(q_mu), q_sqrt,
                   mean_function=mean_function, whiten=whiten, jitter=jitter)

    @property
    def num_inducing(self) -> int:
        return self.Z.shape[0]

    def kuu(self, jitter: float | None = None) -> torch.Tensor:
        """K(Z, Z) + jitter I; ``jitter`` overrides the layer's own."""
        Z = self.Z.value
        if jitter is None:
            jitter = self.jitter
        if jitter is None:
            jitter = default_jitter(Z.dtype)
        eye = torch.eye(Z.shape[0], dtype=Z.dtype, device=Z.device)
        return self.kernel.K(Z) + jitter * eye

    def predict_f(self, Xnew: torch.Tensor, *, full_cov: bool = False,
                  full_output_cov: bool = False, split: bool = False):
        """Posterior q(f(Xnew)) at Xnew [..., N, D]: the mean [..., N, K]
        and the marginal variances [..., N, K], or with ``full_cov`` the
        covariance over the N points per latent, [..., K, N, N].
        ``split`` takes a float32 marginal variance's q_sqrt term by the
        3-pass bf16 split instead of one bf16 pass
        (tril_kernel.atl_sq_colsum): SMGP asks for it.

        Leading dimensions are independent batches, as JAX's vmap makes
        them: marginals are taken on all points at once, a joint
        covariance per batch."""
        chk = ShapeChecker()
        chk.check(self.Z.value, "M D", "Z")
        chk.check(Xnew, "... N D", "Xnew")
        if Xnew.ndim > 2 and full_cov:
            outs = [self.predict_f(x, full_cov=True,
                                   full_output_cov=full_output_cov)
                    for x in Xnew]
            return tuple(torch.stack(t) for t in zip(*outs))
        lead = Xnew.shape[:-2]
        Xnew = Xnew.reshape(-1, Xnew.shape[-1])
        Kmm = self.kuu()
        Kmn = self.kernel.K(self.Z.value, Xnew)
        Knn = self.kernel(Xnew, full_cov=full_cov)
        fmean, fvar = base_conditional(Kmn, Kmm, Knn, self.q_mu.value,
                                       q_sqrt=self.q_sqrt.value,
                                       full_cov=full_cov, white=self.whiten,
                                       split=split)
        if self.mean_function is not None:
            fmean = fmean + self.mean_function(Xnew)
        if lead:
            fmean = fmean.reshape(*lead, -1, fmean.shape[-1])
            fvar = fvar.reshape(*lead, -1, fvar.shape[-1])
        return fmean, expand_independent_outputs(fvar, full_cov,
                                                 full_output_cov)

    def predict_mean(self, Xnew: torch.Tensor) -> torch.Tensor:
        """The marginal posterior mean at Xnew [..., N, D]: [..., N, K],
        predict_f's (which does not depend on ``split``)."""
        return self.predict_f(Xnew)[0]

    def predict_f_samples(self, generator: torch.Generator, Xnew: torch.Tensor,
                          num_samples: int = 1, *,
                          full_cov: bool = True) -> torch.Tensor:
        """Draws from q(f(Xnew)), [S, N, K] (svgp.py:102-126).

        ``full_cov=True`` draws from the joint posterior over Xnew: mean +
        L z with L the Cholesky factor of each latent's [N, N] covariance
        plus jitter I.  A covariance that is not positive definite gives
        NaN from its failed column on, per latent (the draws of that latent
        are then NaN, as JAX's are), with no exception and no read of the
        info code back to the host.  This batched [K, N, N] factor is the
        one Cholesky, with ``reparameterize(full_cov=True)``'s, that
        stays a library call (ops.linalg.cholesky_nan):
        the JAX package's Pallas routing sends batched inputs to XLA too,
        and its autograd carries path B's draws.  ``full_cov=False``
        draws each point from its marginal.  z is drawn from ``generator``,
        [S, K, N, 1] for the joint form, [S, N, K] for the marginal one.
        """
        mean, var = self.predict_f(Xnew, full_cov=full_cov)
        jitter = default_jitter(mean.dtype)
        if not full_cov:
            z = torch.randn((num_samples, *mean.shape), generator=generator,
                            dtype=mean.dtype, device=mean.device)
            return mean + z * torch.sqrt(var.clamp_min(0.0) + jitter)
        L = _cholesky_nan(add_jitter(var, jitter))               # [K, N, N]
        z = torch.randn((num_samples, *var.shape[:-1], 1), generator=generator,
                        dtype=mean.dtype, device=mean.device)    # [S, K, N, 1]
        f = L @ z[..., 0].permute(1, 2, 0)                       # [K, N, S]
        return mean[None] + f.permute(2, 1, 0)                   # [S, N, K]

    def prior_kl(self) -> torch.Tensor:
        """KL[q(u) || p(u)]: p = N(0, I) whitened, N(0, Kuu) otherwise
        (svgp.py:128-132)."""
        return gauss_kl(self.q_mu.value, self.q_sqrt.value,
                        None if self.whiten else self.kuu(),
                        assume_tril=self.q_sqrt.transform == "tril")
