"""The whitened KL's q_sqrt terms over the lower triangle: the CUDA kernels
for the forward sums and the backward scale, and their plain versions.

Replaces modulatedgps_tpu/ops/pallas_kl.py:_k_fwd (``kl_sq_logdiag``) and
_k_bwd (``kl_bwd_scale``); the kernels are csrc/kl_tril.cu.  Both are
streaming passes bound by device memory (the forward reads the lower
triangle of [K, M, M] once; the backward reads it and writes dLq whole).

The forward's two sums stay on the device as 0-dim tensors, and the
backward reads its cotangent g from the device, so neither makes the host
wait.  The forward runs a persistent grid of a few CTAs an SM, each warp a
fixed share of the row pairs, and adds the CTAs' f64 partials in a fixed
order in its last CTA: the same inputs give the same bits.  The library
sizes that grid from the card and says how much scratch it needs
(``fwd_scratch_slots``); the launcher derives the grid from the scratch.  The backward writes exact zeros above the
diagonal (the TPU kernel left garbage there for a downstream mask).

Each wrapper takes its plain version only for CPU tensors; for CUDA tensors
it launches the kernel or raises.  Every launch adds one to the wrapper's
``launches``.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _native

__all__ = ["kl_sq_logdiag", "kl_sq_logdiag_plain", "kl_bwd_scale",
           "kl_bwd_scale_plain", "check_launch_args", "fwd_scratch_slots"]


def fwd_scratch_slots(device):
    """The f64 slots of the forward's scratch on the card ``device``: two
    partials for each CTA of its persistent grid, and the counter's."""
    slots = ctypes.c_int(0)
    code = _native.library().mgp_kl_fwd_scratch(device.index,
                                                 ctypes.addressof(slots))
    _native.check(code, "kl_sq_logdiag")
    return slots.value


def kl_sq_logdiag_plain(Lq):
    """(sum of tril(Lq)^2, sum of log|diag Lq|) of [K, M, M]: two 0-dim
    tensors."""
    logdiag = torch.log(torch.diagonal(Lq, dim1=-2, dim2=-1).abs()).sum()
    return torch.tril(Lq).square().sum(), logdiag


def kl_bwd_scale_plain(Lq, g):
    """g (Lq - diag(1/diag Lq)) on and below the diagonal, 0 above:
    [K, M, M] (modulatedgps_tpu/ops/kl.py:_dense_kl_bwd)."""
    eye = torch.eye(Lq.shape[-1], dtype=torch.bool, device=Lq.device)
    safe = torch.where(eye, Lq, torch.ones_like(Lq))
    return torch.tril(g * torch.where(eye, Lq - 1.0 / safe, Lq))


def _check_shape(what, Lq):
    if Lq.ndim != 3 or Lq.shape[1] != Lq.shape[2]:
        raise ValueError(f"{what}: expected Lq [K, M, M], got {tuple(Lq.shape)}")
    if Lq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {Lq.device}")
    return Lq.device.type == "cuda"


def check_launch_args(what, Lq, g=None):
    _native.require(f"{what} Lq", Lq, torch.float32, Lq.device)
    if g is not None:
        _native.require(f"{what} g", g, torch.float32, Lq.device)
        if g.numel() != 1:
            raise ValueError(f"{what}: g must hold one value, got {tuple(g.shape)}")


def kl_sq_logdiag(Lq):
    """(sum_{j <= i} Lq[k, i, j]^2, sum log|Lq[k, i, i]|) of Lq [K, M, M]:
    two 0-dim f32 tensors on Lq's device (the upper triangle is not read)."""
    if not _check_shape("kl_sq_logdiag", Lq):
        return kl_sq_logdiag_plain(Lq)
    check_launch_args("kl_sq_logdiag", Lq)
    K, M, _ = Lq.shape
    slots = fwd_scratch_slots(Lq.device)
    partial = torch.empty(slots, dtype=torch.float64, device=Lq.device)
    out = torch.empty(2, dtype=torch.float32, device=Lq.device)
    code = _native.library().mgp_kl_fwd(
        Lq.data_ptr(), partial.data_ptr(), out.data_ptr(), M, K, slots,
        _native.stream_ptr(Lq.device))
    _native.check(code, "kl_sq_logdiag")
    kl_sq_logdiag.launches += 1
    return out[0], out[1]


def kl_bwd_scale(Lq, g):
    """dLq = g (Lq - diag(1/diag Lq)) on and below the diagonal, exactly 0
    above: Lq [K, M, M], g a 0-dim tensor on Lq's device -> [K, M, M]."""
    if not _check_shape("kl_bwd_scale", Lq):
        return kl_bwd_scale_plain(Lq, g)
    check_launch_args("kl_bwd_scale", Lq, g)
    K, M, _ = Lq.shape
    dLq = torch.empty_like(Lq)
    code = _native.library().mgp_kl_bwd(
        Lq.data_ptr(), g.data_ptr(), dLq.data_ptr(), M, K,
        _native.stream_ptr(Lq.device))
    _native.check(code, "kl_bwd_scale")
    kl_bwd_scale.launches += 1
    return dLq


kl_sq_logdiag.launches = 0
kl_bwd_scale.launches = 0
