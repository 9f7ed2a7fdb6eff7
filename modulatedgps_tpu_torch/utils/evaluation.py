"""Evaluation metrics for mixture-GP predictions (RMSE, NLPD, accuracy).

Mirrors modulatedgps_tpu/utils/evaluation.py on the port's SMGP: numpy
arrays or tensors in (moved to the model's device and dtype), Python floats
out, no gradient recorded.
"""
from __future__ import annotations

import itertools

import numpy as np
import torch

__all__ = ["mixture_rmse", "mixture_nlpd", "assignment_accuracy"]


def _on_model(model, a) -> torch.Tensor:
    p = next(model.parameters())
    return torch.as_tensor(a, dtype=p.dtype, device=p.device)


@torch.no_grad()
def mixture_rmse(model, X, Y) -> float:
    """RMSE of the assignment-weighted mixture mean sum_k pi_k mu_k."""
    X, Y = _on_model(model, X), _on_model(model, Y)
    pi = model.predict_assign(X)
    Fmu, _ = model.pred_layer.predict_f(X)
    mean, _ = model.likelihood.predict_mean_and_var(Fmu, torch.zeros_like(Fmu))
    mix_mean = (pi * mean).sum(-1, keepdim=True)
    return float(torch.sqrt((mix_mean - Y).square().mean()))


@torch.no_grad()
def mixture_nlpd(model, X, Y) -> float:
    """Mean negative log predictive density under the mixture."""
    return float(-model.predict_density(_on_model(model, X),
                                        _on_model(model, Y)).mean())


@torch.no_grad()
def assignment_accuracy(model, X, labels) -> float:
    """Fraction of points whose argmax assignment matches integer labels, up
    to a permutation of the components (the best over all K! of them)."""
    pi = model.predict_assign(_on_model(model, X)).cpu().numpy()
    pred = np.argmax(pi, axis=-1)
    labels = np.asarray(labels).reshape(-1)
    best = 0.0
    for perm in itertools.permutations(range(pi.shape[-1])):
        best = max(best, float(np.mean(np.asarray(perm)[pred] == labels)))
    return best
