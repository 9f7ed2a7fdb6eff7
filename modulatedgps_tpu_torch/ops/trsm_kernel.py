"""X = L^-1 B for lower-triangular L: the CUDA kernel and its plain version.

Replaces modulatedgps_tpu/ops/pallas_linalg.py:_trsm_kernel (reached there
through solve_triangular_blocked / solve_triangular_large and
linalg._pallas_trinv).  The kernel is csrc/trsm.cu.  On the H100 the
substitution's sequential walk over block rows bounds it, not memory: one
launch inverts the 64x64 diagonal blocks, and a second gives each
16-column strip of B its own CUDA block, which walks the block rows in
order (the TPU's fori_loop over row blocks) with fp32 FMAs only.  For the
inverse (B = I, ``B=None``) a strip skips the block rows above its diagonal.

``trsm_lower`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  Every call that launches adds
one to ``trsm_lower.launches``.
"""
from __future__ import annotations

import torch

from .. import _native

__all__ = ["trsm_lower", "trsm_lower_plain", "check_launch_args", "BLOCK"]

BLOCK = 64   # diagonal block size of csrc/trsm.cu


def trsm_lower_plain(L, B=None):
    if B is None:
        B = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, B, upper=False)


def check_launch_args(L, B=None):
    _native.require("trsm_lower L", L, torch.float32, L.device)
    if B is not None:
        _native.require("trsm_lower B", B, torch.float32, L.device)


def trsm_lower(L, B=None):
    """L^-1 B for L [M, M] (upper triangle ignored) and B [M, Nb]; B=None
    means the identity, i.e. the triangular inverse."""
    if L.ndim != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(f"trsm_lower: L must be [M, M], got {tuple(L.shape)}")
    if B is not None and (B.ndim != 2 or B.shape[0] != L.shape[0]):
        raise ValueError(f"trsm_lower: B must be [{L.shape[0]}, Nb], got "
                         f"{tuple(B.shape)}")
    if L.device.type == "cpu":
        return trsm_lower_plain(L, B)
    if L.device.type != "cuda":
        raise ValueError(f"trsm_lower: unsupported device {L.device}")
    check_launch_args(L, B)
    M = L.shape[0]
    Nb = M if B is None else B.shape[1]
    X = torch.empty((M, Nb), dtype=torch.float32, device=L.device)
    inv = torch.empty(((M + BLOCK - 1) // BLOCK, BLOCK, BLOCK),
                      dtype=torch.float32, device=L.device)
    code = _native.library().mgp_trsm_lower(
        L.data_ptr(), inv.data_ptr(), None if B is None else B.data_ptr(),
        X.data_ptr(), M, Nb, int(B is None), _native.stream_ptr(L.device))
    _native.check(code, "trsm_lower")
    trsm_lower.launches += 1
    return X


trsm_lower.launches = 0
