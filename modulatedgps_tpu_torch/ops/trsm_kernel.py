"""X = L^-1 B and X = L^-T B for lower-triangular L: the CUDA kernels and
their plain versions.

Replaces modulatedgps_tpu/ops/pallas_linalg.py:_trsm_kernel (reached there
through solve_triangular_blocked / solve_triangular_large and
linalg._pallas_trinv) and _trsm_t_kernel (the same calls with
``trans=True``).  The kernels are csrc/trsm.cu.  On the H100 the forward
substitution of an inverse is bound by its sequential walk over block rows;
a solve with a wide B by the rate of its fp32 FMAs.  One launch inverts the
64x64 diagonal blocks, and a second gives each 16-column strip of B its own
CUDA block, which walks the block rows in order (the TPU's fori_loop over row
blocks) with fp32 FMAs only: downwards for L^-1 B, upwards for L^-T B.  For
the inverse (B = I, ``B=None``) a strip skips the block rows above its
diagonal.

``trsm_lower`` and ``trsm_lower_t`` take the plain version only for CPU
tensors; for CUDA tensors they launch the kernel or raise.  Every call that
launches adds one to the wrapper's ``launches``.
"""
from __future__ import annotations

import torch

from .. import _native

__all__ = ["trsm_lower", "trsm_lower_plain", "trsm_lower_t",
           "trsm_lower_t_plain", "check_launch_args", "BLOCK"]

BLOCK = 64   # diagonal block size of csrc/trsm.cu


def trsm_lower_plain(L, B=None):
    if B is None:
        B = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, B, upper=False)


def trsm_lower_t_plain(L, B):
    return torch.linalg.solve_triangular(L.tril().T, B, upper=True)


def check_launch_args(L, B=None, what="trsm_lower"):
    _native.require(f"{what} L", L, torch.float32, L.device)
    if B is not None:
        _native.require(f"{what} B", B, torch.float32, L.device)


def _check_shapes(what, L, B):
    if L.ndim != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(f"{what}: L must be [M, M], got {tuple(L.shape)}")
    if B is not None and (B.ndim != 2 or B.shape[0] != L.shape[0]):
        raise ValueError(f"{what}: B must be [{L.shape[0]}, Nb], got "
                         f"{tuple(B.shape)}")
    if L.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {L.device}")
    return L.device.type == "cuda"


def _launch(what, L, B, *args):
    """Allocate X and the diagonal-block scratch, launch, check."""
    check_launch_args(L, B, what)
    M = L.shape[0]
    Nb = M if B is None else B.shape[1]
    X = torch.empty((M, Nb), dtype=torch.float32, device=L.device)
    inv = torch.empty(((M + BLOCK - 1) // BLOCK, BLOCK, BLOCK),
                      dtype=torch.float32, device=L.device)
    code = getattr(_native.library(), f"mgp_{what}")(
        L.data_ptr(), inv.data_ptr(), None if B is None else B.data_ptr(),
        X.data_ptr(), M, Nb, *args, _native.stream_ptr(L.device))
    _native.check(code, what)
    return X


def trsm_lower(L, B=None):
    """L^-1 B for L [M, M] (upper triangle ignored) and B [M, Nb]; B=None
    means the identity, i.e. the triangular inverse."""
    if not _check_shapes("trsm_lower", L, B):
        return trsm_lower_plain(L, B)
    X = _launch("trsm_lower", L, B, int(B is None))
    trsm_lower.launches += 1
    return X


def trsm_lower_t(L, B):
    """L^-T B for L [M, M] (upper triangle ignored) and B [M, Nb]."""
    if B is None:
        raise ValueError("trsm_lower_t: B must be [M, Nb], got None")
    if not _check_shapes("trsm_lower_t", L, B):
        return trsm_lower_t_plain(L, B)
    X = _launch("trsm_lower_t", L, B)
    trsm_lower_t.launches += 1
    return X


trsm_lower.launches = 0
trsm_lower_t.launches = 0
