"""K(X, X2) for the stationary kernels: the CUDA kernel and its plain version.

Replaces modulatedgps_tpu/ops/pallas_kernels.py:_kxz_pallas (reached there
through rbf_kxz / matern32_kxz).  The kernel is csrc/kxz.cu: on the H100 it
is bound by the N*M*4-byte store of the result, so it stages the scaled X2
rows of a tile in shared memory, keeps the cross term in fp32 registers (D
is a handful of FMAs; no TF32, no tensor cores) and writes each output once
with coalesced row stores.  The signal variance is folded into the epilogue.

``kxz`` takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  Every launch adds one to ``kxz.launches``.
On the card ``kxz`` is an autograd Function: the forward launches the
kernel, the backward is the gradient of the dense formula (``kxz_plain``
recomputed in fp32, TF32 off), which is what JAX differentiates too
(XLA autodiff of _rbf_xla / _matern32_xla, pallas_kernels.py:164-184).
"""
from __future__ import annotations

import math

import torch

from .. import _native

__all__ = ["kxz", "kxz_launch", "kxz_plain", "check_launch_args", "KINDS"]

KINDS = {"rbf": 0, "matern32": 1}


def kxz_plain(X, X2, lengthscales, variance, *, kind: str = "rbf"):
    """Dense formula mirroring pallas_kernels._rbf_xla / _matern32_xla:
    |x|^2 + |z|^2 - 2 x.z on the scaled inputs, clamped at 0."""
    Xs, Zs = X / lengthscales, X2 / lengthscales
    d2 = ((Xs ** 2).sum(-1)[:, None] + (Zs ** 2).sum(-1)[None, :]
          - 2.0 * (Xs @ Zs.T))
    d2 = d2.clamp_min(0.0)
    if kind == "rbf":
        return variance * torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + 1e-36)
    s3 = math.sqrt(3.0)
    return variance * (1.0 + s3 * r) * torch.exp(-s3 * r)


def check_launch_args(X, X2, lengthscales, variance):
    """Checks for the CUDA launch; returns (lengthscales [D], variance [1])
    as contiguous fp32 tensors on X's device."""
    _native.require("kxz X", X, torch.float32, X.device)
    _native.require("kxz X2", X2, torch.float32, X.device)
    _native.require("kxz lengthscales", lengthscales, torch.float32, X.device)
    _native.require("kxz variance", variance, torch.float32, X.device)
    D = X.shape[1]
    if lengthscales.numel() not in (1, D):
        raise ValueError(f"kxz: lengthscales must be a scalar or [{D}], "
                         f"got {tuple(lengthscales.shape)}")
    if variance.numel() != 1:
        raise ValueError("kxz: variance must be a scalar")
    ls = lengthscales.reshape(-1).expand(D).contiguous()
    return ls, variance.reshape(1).contiguous()


def kxz(X, X2, lengthscales, variance, *, kind: str = "rbf"):
    """K [N, M] = variance * phi(|x/l - z/l|^2) for X [N, D], X2 [M, D]."""
    if kind not in KINDS:
        raise ValueError(f"kxz: unknown kind {kind!r}; have {list(KINDS)}")
    if X.ndim != 2 or X2.ndim != 2 or X.shape[1] != X2.shape[1]:
        raise ValueError(f"kxz: expected [N, D] and [M, D], got "
                         f"{tuple(X.shape)} and {tuple(X2.shape)}")
    if X.device.type == "cpu":
        return kxz_plain(X, X2, lengthscales, variance, kind=kind)
    if X.device.type != "cuda":
        raise ValueError(f"kxz: unsupported device {X.device}")
    return _Kxz.apply(X, X2, lengthscales, variance, kind)


class _Kxz(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, X2, lengthscales, variance, kind):
        ctx.save_for_backward(X, X2, lengthscales, variance)
        ctx.kind = kind
        return kxz_launch(X, X2, lengthscales, variance, kind=kind)

    @staticmethod
    def backward(ctx, Kbar):
        need = ctx.needs_input_grad[:4]
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_(n)
                      for t, n in zip(ctx.saved_tensors, need)]
            K = kxz_plain(*leaves, kind=ctx.kind)
            grads = iter(torch.autograd.grad(
                K, [t for t, n in zip(leaves, need) if n], Kbar))
        return (*(next(grads) if n else None for n in need), None)


def kxz_launch(X, X2, lengthscales, variance, *, kind: str = "rbf"):
    """The raw launcher: X [N, D], X2 [M, D] fp32 on the card -> [N, M]."""
    ls, var = check_launch_args(X, X2, lengthscales, variance)
    N, D = X.shape
    M = X2.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=X.device)
    code = _native.library().mgp_kxz(
        X.data_ptr(), X2.data_ptr(), ls.data_ptr(), var.data_ptr(),
        out.data_ptr(), N, M, D, KINDS[kind], _native.stream_ptr(X.device))
    _native.check(code, "kxz")
    kxz.launches += 1
    return out


kxz.launches = 0
