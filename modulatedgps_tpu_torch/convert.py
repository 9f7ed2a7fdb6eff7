"""Carry a model's parameters between the JAX package and the port.

``load_numpy_`` copies raw leaves keyed by their JAX pytree paths into any
port model built with the same constructors.  ``smgp_from_numpy`` takes
the JAX model's raw (unconstrained) leaves as numpy arrays keyed by their
pytree path, for example ``pred_layer.q_sqrt.raw``, and returns the port's
SMGP; ``smgp_to_numpy`` (of any port model) is its inverse.  The dict is
what ``jax.tree_util.tree_flatten_with_path`` gives for a
``modulatedgps_tpu.models.SMGP`` with a Gaussian likelihood and two
SquaredExponential SVGP layers (neither the kernel type nor ``whiten``, a
static field in JAX, is among the leaves: ``whiten`` is passed); this
module itself never imports jax.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .likelihoods.gaussian import Gaussian
from .models.smgp import SMGP
from .models.svgp import SVGP
from .ops.kernels import SquaredExponential
from .params import Parameter

__all__ = ["load_numpy_", "smgp_from_numpy", "smgp_to_numpy"]


@torch.no_grad()
def load_numpy_(module: torch.nn.Module,
                arrays: Mapping[str, np.ndarray]) -> torch.nn.Module:
    """Copy raw (unconstrained) leaves into ``module`` in place; returns it.

    ``arrays`` is keyed by the JAX pytree paths,
    ``jax.tree_util.keystr(path, simple=True, separator=".")`` of
    ``tree_flatten_with_path``: ``pred_layer.kernel.kernels.0.variance.raw``,
    ``assign_likelihood.variance.raw`` (a leading '.' is ignored).  Those
    are the port's parameter names when the module mirrors the JAX model.
    JAX's static fields (kernel and likelihood types, ``whiten``, K, S) are
    not leaves: the caller builds the skeleton.  Each array is cast to its
    parameter's dtype and device.  Raises ValueError, before copying
    anything, on a missing key, an extra key or a shape that differs.
    """
    raw = {key.lstrip("."): value for key, value in arrays.items()}
    params = dict(module.named_parameters())
    missing = sorted(set(params) - set(raw))
    extra = sorted(set(raw) - set(params))
    if missing or extra:
        raise ValueError(f"load_numpy_: the arrays do not fit the module: "
                         f"missing {missing}, unexpected {extra}")
    for name, p in params.items():
        shape = np.shape(raw[name])
        if shape != tuple(p.shape):
            raise ValueError(f"load_numpy_: {name} has shape {shape}, the "
                             f"module's {tuple(p.shape)}")
    for name, p in params.items():
        p.copy_(torch.as_tensor(np.array(raw[name])))
    return module


def _layer(raw, prefix: str, whiten, jitter, dtype, device) -> SVGP:
    def get(name):
        return torch.tensor(np.asarray(raw[f"{prefix}.{name}.raw"]),
                            dtype=dtype, device=device)

    kernel = SquaredExponential(
        Parameter(get("kernel.variance"), "positive"),
        Parameter(get("kernel.lengthscales"), "positive"))
    q_sqrt = get("q_sqrt")
    return SVGP(kernel, Parameter(get("Z")), Parameter(get("q_mu")),
                Parameter(q_sqrt, "tril" if q_sqrt.ndim == 3 else "positive"),
                whiten=whiten, jitter=jitter)


def smgp_from_numpy(arrays: Mapping[str, np.ndarray], *, K: int,
                    num_samples: int, num_data: int | None,
                    temperature: float, device: torch.device | str,
                    dtype: torch.dtype, jitter: float | None = None,
                    whiten: bool = True) -> SMGP:
    """The port's SMGP from raw leaves keyed ``likelihood.variance.raw``,
    ``{pred_layer,assign_layer}.{kernel.variance,kernel.lengthscales,Z,q_mu,
    q_sqrt}.raw`` (a leading '.' in a key is ignored).

    ``jitter`` is the layers' Kuu jitter (None: the dtype's default); a
    whitened model is evaluated at the jitter it was trained with.
    ``whiten`` is both layers' parameterization.
    """
    raw = {key.lstrip("."): value for key, value in arrays.items()}
    lik = Gaussian(Parameter(torch.tensor(
        np.asarray(raw["likelihood.variance.raw"]), dtype=dtype,
        device=device), "positive"))
    pred = _layer(raw, "pred_layer", whiten, jitter, dtype, device)
    assign = _layer(raw, "assign_layer", whiten, jitter, dtype, device)
    return SMGP(lik, pred, assign, K=K, num_samples=num_samples,
                num_data=num_data, temperature=temperature)


def smgp_to_numpy(model: SMGP) -> dict[str, np.ndarray]:
    """The port's SMGP as raw leaves keyed by the JAX pytree paths (the
    keys ``smgp_from_numpy`` reads), as numpy arrays on the host.  The
    port's module tree mirrors the JAX pytree, so its parameter names are
    those paths."""
    return {name: p.detach().cpu().numpy()
            for name, p in model.named_parameters()}
