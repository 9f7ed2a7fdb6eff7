"""Mixture of SVGPs with GP-modulated data association (SMGP).

Mirrors modulatedgps_tpu/models/smgp.py:74-237 (noise, the doubly
stochastic ELBO, SMGPModified's two-term one) and its prediction and
sampling methods.  K experts share the inputs; the prediction layer gives
per-expert latents f_k and the assignment layer
gives the logits of the mixture weights, drawn through a temperature-1e-2
Gumbel-softmax to soft one-hot weights W [S, N, K].  The ELBO is

    mean_n[ logsumexp_S( sum_k VE_k(n) W_snk ) - log S ]
        - (KL_pred + KL_assign) / num_data,

with each layer's conditional computed once on [N, D] and only the S
Gaussian and Gumbel draws per sample.  A layer is anything with
``predict_f(X) -> ([N, K], [N, K])`` and ``predict_mean(X) -> [N, K]``:
a trained ``SVGP`` (the training-path conditional) or, for prediction
only, a ``PrecomputedPosterior`` (see posterior.precompute_smgp).

At tau = 1e-2 W is one-hot to float32 rounding, and one bf16 pass in a
layer's q_sqrt variance term (the TPU route's precision class) moves the
expected log-likelihoods or the sampled logits enough to flip near-ties:
the float32 assignment-layer gradients then land up to ~7e-2 of their
scale off float64 at M=48 (tests/test_torch_f32_assign_grad.py).  So SMGP
asks its SVGP layers for that term's forward and dA by the 3-pass bf16
split (``predict_f(split=True)``), which brings every assignment leaf
within 5e-3.  The SMGP needs it on both layers: its Gaussian expected
log-likelihoods move with the prediction layer's variance (over eight
seeds of the M=48 case the split on the assignment layer alone lands a
median 6.4e-3 off, on both 3.3e-3).  The SMGPModified needs it on its
assignment layer only: its MultiClass expectations barely move (within
1.4x of both layers' distance on every seed).
"""
from __future__ import annotations

import copy
import math

import torch
from torch import nn

from ..likelihoods.base import Likelihood
from ..ops.sampling import gumbel, reparameterize
from ..utils.profiling import span
from ..utils.shapes import ShapeChecker
from .svgp import SVGP

__all__ = ["SGP", "SMGP", "SMGPModified"]


class SGP(nn.Module):
    """One prediction layer and a likelihood."""

    def __init__(self, likelihood: Likelihood, pred_layer: nn.Module, *,
                 num_samples: int = 1, num_data: int | None = None):
        super().__init__()
        self.likelihood = likelihood
        self.pred_layer = pred_layer
        self.num_samples = num_samples
        self.num_data = num_data

    def replace(self, **changes):
        """A shallow copy of the same class with ``changes`` set (the JAX
        package's Module.replace): submodules not named are shared."""
        new = copy.copy(self)
        for table in ("_parameters", "_buffers", "_modules"):
            object.__setattr__(new, table, dict(getattr(self, table)))
        for name, value in changes.items():
            setattr(new, name, value)
        return new

    def _marginals(self, layer, Xnew):
        """A layer's marginals at Xnew: ([N, K], [N, K])."""
        return layer.predict_f(Xnew)

    def predict_y(self, Xnew, S: int = 1):
        """Per-expert predictive moments, tiled to [S, N, K] (rows are
        identical across S)."""
        with span("mgp.predict_y", Xnew, "predict"):
            Fmu, Fvar = self._marginals(self.pred_layer, Xnew)
            mean, var = self.likelihood.predict_mean_and_var(Fmu, Fvar)
            return mean.expand(S, *mean.shape), var.expand(S, *var.shape)


class SMGP(SGP):
    def __init__(self, likelihood: Likelihood, pred_layer: nn.Module,
                 assign_layer: nn.Module, *, K: int = 3, num_samples: int = 1,
                 num_data: int | None = None, temperature: float = 1e-2):
        super().__init__(likelihood, pred_layer, num_samples=num_samples,
                         num_data=num_data)
        self.assign_layer = assign_layer
        self.K = K
        self.temperature = temperature

    def _marginals(self, layer, Xnew):
        """An SVGP layer's marginals with the q_sqrt variance term by the
        3-pass split (see the module docstring); any other layer's, such as
        a PrecomputedPosterior's, as it gives them."""
        if isinstance(layer, SVGP):
            return layer.predict_f(Xnew, split=True)
        return layer.predict_f(Xnew)

    # -- assignment weights ------------------------------------------------
    def draw_noise(self, generator: torch.Generator, N: int, S: int,
                   dtype: torch.dtype):
        """(z, g): Gaussian and Gumbel noise, each [S, N, K], on the
        generator's device."""
        shape = (S, N, self.K)
        z = torch.randn(shape, generator=generator, dtype=dtype,
                        device=generator.device)
        return z, gumbel(generator, shape, dtype)

    def W_from_noise(self, Xnew, z, g):
        """Gumbel-softmax assignment weights W [S, N, K] from given noise."""
        amu, avar = self._marginals(self.assign_layer, Xnew)
        return self._W_from_marginals(amu, avar, z, g)

    def sample_W(self, generator: torch.Generator, Xnew, S: int):
        """S Gumbel-softmax assignment draws W [S, N, K] (smgp.py:97-101),
        from noise drawn as draw_noise draws it."""
        amu, avar = self._marginals(self.assign_layer, Xnew)
        z, g = self.draw_noise(generator, Xnew.shape[0], S, amu.dtype)
        return self._W_from_marginals(amu, avar, z, g)

    def _W_from_marginals(self, amu, avar, z, g):
        log_assign = reparameterize(amu, avar, z)                # [S, N, K]
        return torch.softmax((log_assign + g) / self.temperature, dim=-1)

    # -- ELBO --------------------------------------------------------------
    def E_log_p_Y(self, generator: torch.Generator, X, Y):
        z, g = self.draw_noise(generator, X.shape[0], self.num_samples, X.dtype)
        return self.E_log_p_Y_from_noise(X, Y, z, g)

    def E_log_p_Y_from_noise(self, X, Y, z, g):
        """Data-fit term per point [N] from given noise z, g [S, N, K]."""
        fmu, fvar = self._marginals(self.pred_layer, X)
        amu, avar = self._marginals(self.assign_layer, X)
        return self.E_log_p_from_marginals(fmu, fvar, amu, avar, z, g, Y)

    def E_log_p_from_marginals(self, fmu, fvar, amu, avar, z, g, Y):
        """Data-fit term per point [N] from the layers' marginals."""
        W = self._W_from_marginals(amu, avar, z, g)              # [S, N, K]
        ve = self.likelihood.variational_expectations(fmu, fvar, Y)
        summed = (ve[None] * W).sum(2)                           # [S, N]
        return torch.logsumexp(summed, dim=0) - math.log(z.shape[0])

    def elbo(self, generator: torch.Generator, X, Y) -> torch.Tensor:
        if self.num_data is None:
            raise ValueError(
                "SMGP needs num_data (total training-set size) to scale the "
                "KL term; pass num_data=N at construction.")
        chk = ShapeChecker()
        chk.check(X, "N D", "X")
        chk.check(Y, "N .", "Y")
        data_fit = self.E_log_p_Y(generator, X, Y).mean()
        kl = self.pred_layer.prior_kl() + self.assign_layer.prior_kl()
        return data_fit - kl / self.num_data

    def training_loss(self, generator: torch.Generator, X, Y) -> torch.Tensor:
        return -self.elbo(generator, X, Y)

    # -- prediction --------------------------------------------------------
    def predict_assign(self, Xnew):
        """softmax of the mean assignment logits: [N, K].  Only the
        assignment layer's mean is computed, not its variance."""
        with span("mgp.predict_assign", Xnew, "predict"):
            amu = self.assign_layer.predict_mean(Xnew)
            return torch.softmax(amu, dim=-1)

    def predict_density(self, Xnew, Ynew):
        """Mixture predictive log-density log sum_k pi_k(x) p_k(y|x): [N]."""
        with span("mgp.predict_density", Xnew, "predict"):
            pi = self.predict_assign(Xnew)                       # [N, K]
            Fmu, Fvar = self._marginals(self.pred_layer, Xnew)
            log_pk = self.likelihood.predict_density_per_expert(Fmu, Fvar,
                                                                Ynew)
            return torch.logsumexp(torch.log(pi + 1e-12) + log_pk, dim=-1)

    def predict_samples(self, generator: torch.Generator, Xnew, S: int = 1):
        """Mixture draws (samples_y, samples_f), each [S, N, 1]
        (smgp.py:199-212): W from ``sample_W``, then one z [S, N, K] drawn
        after it, reused for both the y and the f draws as the reference
        does."""
        W = self.sample_W(generator, Xnew, S)                    # [S, N, K]
        Fmu, Fvar = self._marginals(self.pred_layer, Xnew)       # [N, K]
        mean, var = self.likelihood.predict_mean_and_var(Fmu, Fvar)
        z = torch.randn((S, *Fmu.shape), generator=generator, dtype=Fmu.dtype,
                        device=generator.device)
        samples_y = (reparameterize(mean, var, z) * W).sum(2, keepdim=True)
        samples_f = (reparameterize(Fmu, Fvar, z) * W).sum(2, keepdim=True)
        return samples_y, samples_f


class SMGPModified(SMGP):
    """An SMGP with a second likelihood on the assignment layer's latents,
    the multiclass demos' model (smgp.py:215-237).  Its data-fit term is

        logsumexp_S(sum_k VE_a,k W - log S) + logsumexp_S(sum_k VE_y,k W - log S)

    with VE_a the assignment likelihood's expectations under the assignment
    marginals and VE_y the likelihood's under the prediction marginals,
    both of the same Y.  Y is cast once to the marginals' dtype, so integer
    labels and a float64 Y alike meet float32 marginals as float32."""

    def __init__(self, likelihood: Likelihood, pred_layer: nn.Module,
                 assign_layer: nn.Module, *,
                 assign_likelihood: Likelihood | None = None, K: int = 3,
                 num_samples: int = 1, num_data: int | None = None,
                 temperature: float = 1e-2):
        super().__init__(likelihood, pred_layer, assign_layer, K=K,
                         num_samples=num_samples, num_data=num_data,
                         temperature=temperature)
        self.assign_likelihood = assign_likelihood

    def _marginals(self, layer, Xnew):
        """The 3-pass split variance term on the assignment layer only (see
        the module docstring)."""
        if isinstance(layer, SVGP) and layer is self.assign_layer:
            return layer.predict_f(Xnew, split=True)
        return layer.predict_f(Xnew)

    def E_log_p_from_marginals(self, fmu, fvar, amu, avar, z, g, Y):
        logS = math.log(z.shape[0])
        Y = Y.to(fmu.dtype)
        W = self._W_from_marginals(amu, avar, z, g)              # [S, N, K]
        ve_a = self.assign_likelihood.variational_expectations(amu, avar, Y)
        E_log_p_A = (ve_a[None] * W).sum(2) - logS               # [S, N]
        ve_y = self.likelihood.variational_expectations(fmu, fvar, Y)
        E_log_p_y = (ve_y[None] * W).sum(2) - logS               # [S, N]
        return (torch.logsumexp(E_log_p_A, dim=0)
                + torch.logsumexp(E_log_p_y, dim=0))             # [N]
