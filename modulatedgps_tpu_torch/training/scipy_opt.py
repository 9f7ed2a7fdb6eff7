"""Full-batch optimization through scipy (L-BFGS-B by default).

Mirrors modulatedgps_tpu/training/scipy_opt.py:31-98 (gpflow's
optimizers.Scipy): the model's trainable floating-point raw leaves are
packed into one float64 numpy vector, in the order of
``model.named_parameters()``, which is the JAX package's flatten order for
a model built with the same constructors; frozen leaves stay as they are,
bit for bit.  Each evaluation copies the vector to the model's device once,
writes it into the leaves there, runs the loss and ``torch.autograd.grad``
in the model's dtype (float32 if every trainable leaf is, as JAX does), and
copies the loss and the gradient back once.  A leaf whose gradient is
exactly 0 (the upper triangle of a "tril" q_sqrt) is never moved by
L-BFGS.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

__all__ = ["run_scipy"]


def run_scipy(model: torch.nn.Module, loss_fn: Callable | None = None, *,
              data: tuple = (), maxiter: int = 1000, method: str = "L-BFGS-B",
              verbose: bool = False, options: dict | None = None):
    """Minimize ``loss_fn(model, *data)`` over the trainable leaves with
    scipy.optimize.minimize; returns ``(model, scipy_result)``.

    The model is updated in place: its trainable leaves end at
    ``scipy_result.x`` (the returned model is the same object).
    ``loss_fn`` defaults to ``model.training_loss()`` (internal-data models
    such as VGP); ``data`` arrays are moved to the model's device once.
    """
    from scipy.optimize import minimize

    if loss_fn is None:
        loss_fn = lambda m: m.training_loss()
    params = [p for p in model.parameters()
              if p.requires_grad and p.is_floating_point()]
    if not params:
        raise ValueError("model has no trainable floating-point leaves")
    device = params[0].device
    data = tuple(torch.as_tensor(d, device=device) for d in data)
    vec_dtype = (torch.float32 if all(p.dtype == torch.float32 for p in params)
                 else torch.float64)
    sizes = [p.numel() for p in params]

    @torch.no_grad()
    def assign(x: np.ndarray) -> None:
        vec = torch.from_numpy(np.ascontiguousarray(x)).to(device, vec_dtype)
        for p, seg in zip(params, torch.split(vec, sizes)):
            p.copy_(seg.view(p.shape))

    evals = {"n": 0}

    def fun(x):
        assign(x)
        with torch.enable_grad():
            loss = loss_fn(model, *data)
            grads = torch.autograd.grad(loss, params, allow_unused=True)
        out = torch.cat([loss.detach().reshape(1).to(vec_dtype)]
                        + [torch.zeros_like(p).view(-1) if g is None
                           else g.reshape(-1).to(vec_dtype)
                           for p, g in zip(params, grads)])
        out = out.cpu().numpy().astype(np.float64)
        evals["n"] += 1
        if verbose and evals["n"] % 20 == 0:
            print(f"  scipy eval {evals['n']}: loss={out[0]:.6f}")
        return out[0], out[1:]

    x0 = np.concatenate([p.detach().cpu().numpy().astype(np.float64).ravel()
                         for p in params])
    result = minimize(fun, x0, jac=True, method=method,
                      options={"maxiter": maxiter, **(options or {})})
    if verbose:
        print(f"scipy {method}: {result.message} "
              f"(nit={result.nit}, loss={result.fun:.6f})")
    assign(result.x)
    return model, result
