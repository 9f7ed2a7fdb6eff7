"""Plain PyTorch for the references: the SVGP marginals, the KL, the
likelihoods, Adam, and the loops that follow a program's steps or
requests.  It imports nothing of the program and takes nothing it made.

A ``Precision`` says how a reference computes: ``reference`` in float64;
``control`` one step below what the configuration states, float32 with
TF32 on for its float32 terms and fp8 (e4m3, per-tensor scale) operands for
the terms it states in bf16.
"""
from __future__ import annotations

import math

import numpy as np
import torch

HALF_LOG_2PI = 0.5 * math.log(2.0 * math.pi)


class Precision:
    """A context in which a reference computes; ``low(x)`` rounds an
    operand of a term the configuration states in bf16."""

    def __init__(self, name: str):
        if name not in ("reference", "control"):
            raise ValueError(f"unknown precision {name!r}")
        self.name = name
        self.dtype = torch.float64 if name == "reference" else torch.float32

    def __enter__(self):
        self._saved = (torch.backends.cuda.matmul.allow_tf32,
                       torch.backends.cudnn.allow_tf32)
        tf32 = self.name == "control"
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = self._saved

    def low(self, x: torch.Tensor) -> torch.Tensor:
        if self.name == "reference":
            return x
        scale = 448.0 / x.detach().abs().amax().clamp_min(1e-30)
        q = (x.detach() * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale
        return x + (q - x).detach()


def softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def se_kernel(A, B, variance, lengthscale):
    """variance exp(-0.5 |(a - b) / l|^2), [len(A), len(B)], by differences
    (no matmul, so no TF32 rounding)."""
    d = ((A / lengthscale)[:, None, :] - (B / lengthscale)[None, :, :])
    return variance * torch.exp(-0.5 * d.square().sum(-1))


def marginals(p: dict, layer: str, X, cfg: dict, prec: Precision,
              low: bool = False):
    """A whitened SVGP layer's q(f(X)) marginals: ([N, K], [N, K]).

        A = chol(Kmm)^-1 Kmn,  fmean = A^T q_mu,
        fvar_k = Kdiag - |A|^2 + |A^T tril(q_sqrt_k)|^2  (clamped at 1e-12)

    ``low``: the q_sqrt term's operands are rounded by ``prec.low``."""
    var = softplus(p[f"{layer}.kernel.variance.raw"])
    ls = softplus(p[f"{layer}.kernel.lengthscales.raw"])
    Z, q_mu = p[f"{layer}.Z.raw"], p[f"{layer}.q_mu.raw"]
    S = torch.tril(p[f"{layer}.q_sqrt.raw"])
    M = Z.shape[0]
    eye = torch.eye(M, dtype=Z.dtype, device=Z.device)
    L = torch.linalg.cholesky(se_kernel(Z, Z, var, ls) + cfg["jitter"] * eye)
    A = torch.linalg.solve_triangular(L, se_kernel(Z, X, var, ls), upper=False)
    fmean = A.T @ q_mu
    if low:
        B = prec.low(A).T[None] @ prec.low(S)
    else:
        B = A.T[None] @ S                                       # [K, N, M]
    fvar = (var - A.square().sum(0))[None, :] + B.square().sum(-1)
    return fmean, fvar.clamp_min(1e-12).T


def whitened_kl(p: dict, layer: str):
    q_mu = p[f"{layer}.q_mu.raw"]
    S = torch.tril(p[f"{layer}.q_sqrt.raw"])
    M, K = q_mu.shape
    logdiag = torch.log(torch.diagonal(S, dim1=-2, dim2=-1).abs()).sum()
    return 0.5 * (q_mu.square().sum() - M * K - 2.0 * logdiag
                  + S.square().sum())


def gaussian_ve(variance, Fmu, Fvar, Y):
    return (-HALF_LOG_2PI - 0.5 * torch.log(variance)
            - 0.5 * ((Y - Fmu).square() + Fvar) / variance)


def gaussian_log_density(variance, Fmu, Fvar, Y):
    var = Fvar + variance
    return -HALF_LOG_2PI - 0.5 * torch.log(var) - 0.5 * (Y - Fmu).square() / var


def robustmax_ve(spec: dict, Fmu, Fvar, Y):
    """E log p(y | f) under RobustMax: p log(1 - eps) + (1 - p) log(eps /
    (K - 1)), p = P(f_y is the largest latent) by Gauss-Hermite quadrature
    over f_y: [N, 1]."""
    K, eps = spec["num_classes"], spec["epsilon"]
    x, w = np.polynomial.hermite.hermgauss(spec["gauss_hermite_points"])
    x = torch.as_tensor(x, dtype=Fmu.dtype, device=Fmu.device)
    w = torch.as_tensor(w, dtype=Fmu.dtype, device=Fmu.device)
    on = torch.nn.functional.one_hot(Y[:, 0].long(), K).to(Fmu.dtype)
    mu_y, var_y = (on * Fmu).sum(-1), (on * Fvar).sum(-1)
    grid = mu_y[:, None] + x * torch.sqrt((2.0 * var_y).clamp_min(1e-10))[:, None]
    z = (grid[:, None, :] - Fmu[..., None]) / torch.sqrt(
        Fvar.clamp_min(1e-10))[..., None]                      # [N, K, P]
    cdf = 0.5 * (1.0 + torch.erf(z / math.sqrt(2.0))) * (1 - 2e-4) + 1e-4
    cdf = cdf * (1.0 - on)[..., None] + on[..., None]
    prob = (torch.prod(cdf, dim=1) * w).sum(-1) / math.sqrt(math.pi)
    ve = prob * math.log(1.0 - eps) + (1.0 - prob) * math.log(eps / (K - 1))
    return ve[:, None]


def assignment_weights(amu, avar, z, u, cfg: dict):
    """Gumbel-softmax weights W [S, N, K] from Gaussian noise z and uniform
    noise u (already clamped away from 0)."""
    logits = amu + z * torch.sqrt(avar + cfg["jitter"])
    gumbel = -torch.log(-torch.log(u))
    return torch.softmax((logits + gumbel) / cfg["temperature"], dim=-1)


def noise(generator: torch.Generator, cfg: dict, n: int, dtype):
    """The draws of one training step, as the program's model makes them:
    Gaussian z, then uniform u clamped at float32's smallest normal, each
    [S, N, K] in float32, cast to ``dtype``."""
    shape = (cfg["S"], n, cfg["K"])
    on = dict(dtype=torch.float32, device=generator.device)
    z = torch.randn(shape, generator=generator, **on)
    u = torch.rand(shape, generator=generator, **on)
    u.clamp_min_(torch.finfo(torch.float32).tiny)
    return z.to(dtype), u.to(dtype)


def adam_(p: dict, grads: dict, m: dict, v: dict, lr: float, t: int,
          b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
    """One Adam step in optax's order of operations, in place."""
    c1, c2 = 1.0 / (1.0 - b1 ** t), 1.0 / (1.0 - b2 ** t)
    with torch.no_grad():
        for k, g in grads.items():
            m[k].mul_(b1).add_((1.0 - b1) * g)
            v[k].mul_(b2).add_((1.0 - b2) * g * g)
            p[k].sub_(lr * (m[k] * c1) / (torch.sqrt(v[k] * c2) + eps))


def train_readings(loss_fn, cfg: dict, state: dict, batches: list,
                   noise_seed: int, steps: int, prec: Precision) -> dict:
    """Follow ``steps`` Adam steps from ``state`` on ``batches`` with the
    noise of a generator seeded ``noise_seed``: each step's loss, every
    leaf's gradient norm at step 1, and every leaf's change norm after the
    last step."""
    with prec, torch.enable_grad():
        p = {k: t.detach().to(prec.dtype).clone().requires_grad_(True)
             for k, t in state.items()}
        start = {k: t.detach().clone() for k, t in p.items()}
        m = {k: torch.zeros_like(t) for k, t in start.items()}
        v = {k: torch.zeros_like(t) for k, t in start.items()}
        device = next(iter(state.values())).device
        gen = torch.Generator(device=device).manual_seed(noise_seed)
        losses, grad_norms = [], {}
        for t in range(steps):
            X, Y = (b.to(prec.dtype) for b in batches[t])
            z, u = noise(gen, cfg, X.shape[0], prec.dtype)
            loss = loss_fn(p, cfg, X, Y, z, u, prec)
            grads = dict(zip(p, torch.autograd.grad(loss, list(p.values()))))
            if t == 0:
                grad_norms = {k: float(g.double().norm()) for k, g in grads.items()}
            losses.append(float(loss.detach()))
            del loss
            adam_(p, grads, m, v, cfg["lr"], t + 1)
            del grads
        change = {k: float((p[k].detach() - start[k]).double().norm())
                  for k in p}
    return {"losses": losses, "grad_norms": grad_norms, "change_norms": change}


def serve_outputs(predict_fn, cfg: dict, state: dict, requests: list,
                  prec: Precision) -> list:
    """The outputs of ``predict_fn(p, cfg, X, Y, prec)`` for each request
    (X, Y), in float64 on the device."""
    out = []
    with prec, torch.no_grad():
        p = {k: t.to(prec.dtype) for k, t in state.items()}
        for X, Y in requests:
            got = predict_fn(p, cfg, X.to(prec.dtype), Y.to(prec.dtype), prec)
            out.append({k: t.double() for k, t in got.items()})
    return out
