"""Gauss-Hermite quadrature for the non-conjugate likelihoods' expectations.

Mirrors modulatedgps_tpu/ops/quadrature.py.  Nodes and weights come from
numpy's ``hermgauss`` on the host, once per (n, dtype, device): the cached
tensors are constants, shared by every caller, and must not be written to.
The constants the formulas divide by (sqrt 2, sqrt pi) are rounded as the
JAX package rounds them, in the tensor's dtype.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

__all__ = ["DEFAULT_NUM_POINTS", "gauss_hermite_points",
           "gauss_hermite_expectation", "sqrt_const"]

DEFAULT_NUM_POINTS = 20  # gpflow RobustMax default

_NUMPY = {torch.float32: np.float32, torch.float64: np.float64}


def sqrt_const(value: float, dtype: torch.dtype) -> float:
    """sqrt(value) taken in ``dtype`` (jnp.sqrt(jnp.asarray(value, dtype)))."""
    return float(np.sqrt(np.asarray(value, _NUMPY[dtype])))


@functools.lru_cache(maxsize=None)
def _points(n: int, dtype: torch.dtype, device: torch.device):
    x, w = np.polynomial.hermite.hermgauss(n)
    return (torch.as_tensor(x, dtype=dtype, device=device),
            torch.as_tensor(w, dtype=dtype, device=device))


def gauss_hermite_points(n: int, dtype: torch.dtype,
                         device: torch.device | str = "cuda"):
    """Physicists' Hermite nodes x_i and weights w_i, each [n]:
    int e^{-x^2} f(x) dx ~ sum_i w_i f(x_i)."""
    return _points(n, dtype, torch.device(device))


def gauss_hermite_expectation(fn, Fmu: torch.Tensor, Fvar: torch.Tensor,
                              num_points: int = DEFAULT_NUM_POINTS):
    """E_{f ~ N(Fmu, Fvar)}[fn(f)], elementwise over Fmu / Fvar.

    With f = mu + sqrt(2 var) x this is (1 / sqrt(pi)) sum_i w_i
    fn(mu + sqrt(2 var) x_i); ``fn`` maps [..., P] node values to [..., P].
    """
    x, w = gauss_hermite_points(num_points, Fmu.dtype, Fmu.device)
    f = Fmu[..., None] + torch.sqrt(2.0 * Fvar[..., None]) * x
    return fn(f) @ w / sqrt_const(np.pi, Fmu.dtype)
