"""Reparameterized sampling: Gaussian and Gumbel-softmax (relaxed one-hot).

Mirrors modulatedgps_tpu/ops/sampling.py:19-57 (``reparameterize``,
diagonal or full-covariance, ``gumbel_softmax_logits``, ``relaxed_one_hot``).
Randomness comes from an explicit ``torch.Generator`` on the device of the
draw; its numbers differ from JAX's threefry, so parity tests hand both
packages the same noise.  Gumbel noise is -log(-log U), U uniform on
(0, 1) with 0 excluded as jax.random.gumbel does (U >= the dtype's
smallest normal).
"""
from __future__ import annotations

import torch

from ..config import default_jitter
from .linalg import add_jitter, cholesky_nan

__all__ = ["reparameterize", "gumbel", "gumbel_softmax_logits",
           "relaxed_one_hot"]


def reparameterize(mean: torch.Tensor, var: torch.Tensor | None,
                   z: torch.Tensor, *, full_cov: bool = False,
                   jitter: float | None = None):
    """mean + z sqrt(var + jitter); z ~ N(0, 1) gives a draw of N(mean, var).

    ``full_cov``: mean and z [..., N, D], var [..., N, N, D], one joint
    draw per output d, mean + chol(var_d + jitter I) z_d.  That batched
    [..., D, N, N] factor is ops.linalg.cholesky_nan, a library call (the
    JAX package sends batched factors to XLA too): a covariance that is not
    positive definite gives NaN from its failed column on, no exception.
    """
    if var is None:
        return mean
    jit = default_jitter(mean.dtype) if jitter is None else jitter
    if not full_cov:
        return mean + z * torch.sqrt(var + jit)
    chol = cholesky_nan(add_jitter(torch.movedim(var, -1, -3), jit))
    f = mean.transpose(-1, -2) + (chol @ z.transpose(-1, -2)[..., None])[..., 0]
    return f.transpose(-1, -2)


def gumbel(generator: torch.Generator, shape, dtype: torch.dtype):
    """Standard Gumbel(0, 1) noise on the generator's device."""
    u = torch.rand(shape, generator=generator, dtype=dtype,
                   device=generator.device)
    return -torch.log(-torch.log(u.clamp_min_(torch.finfo(dtype).tiny)))


def gumbel_softmax_logits(generator: torch.Generator, logits: torch.Tensor,
                          temperature: float) -> torch.Tensor:
    """(logits + G) / tau with G ~ Gumbel(0, 1): the pre-softmax logits of a
    RelaxedOneHotCategorical draw."""
    return (logits + gumbel(generator, logits.shape, logits.dtype)) / temperature


def relaxed_one_hot(generator: torch.Generator, logits: torch.Tensor,
                    temperature: float = 1e-2) -> torch.Tensor:
    """Soft one-hot weights over the trailing axis; softmax is
    shift-invariant, so tau = 1e-2 stays finite in float32."""
    return torch.softmax(gumbel_softmax_logits(generator, logits, temperature),
                         dim=-1)
