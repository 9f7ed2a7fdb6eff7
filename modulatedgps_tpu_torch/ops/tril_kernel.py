"""The q_sqrt variance term sum_m' (A^T tril L_k)^2: the CUDA kernel for
B16 = bf16(A^T tril L) and its plain version.

Replaces modulatedgps_tpu/ops/pallas_tril.py:_k_fwd_b16 (reached there
through atl_sq_colsum).  The kernel is csrc/tril_fwd.cu.  On the H100 the
op is tensor-core bound (K*N*M^2/2 = 5.5e11 multiply-adds a layer at
M=4096, N=8192, K=8), so it runs bf16 wmma fragments with fp32
accumulators held over the whole m-run, visits only the m-tiles on or
below each output tile's diagonal, and zeroes L's strictly-upper entries
as it stages them.

As in JAX, the bf16 casts happen in ``atl_sq_colsum`` and the square-sum
over m' runs outside the kernel: B16 stays the kernel's output because the
backward kernels of the training slice read it.

``tril_sq_fwd`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  Every launch adds one to
``tril_sq_fwd.launches``.
"""
from __future__ import annotations

import torch

from .. import _native

__all__ = ["tril_sq_fwd", "tril_sq_fwd_plain", "atl_sq_colsum",
           "check_launch_args"]


def tril_sq_fwd_plain(A16, L16):
    """bf16(A^T tril(L)) with fp32 accumulation: [M, N], [K, M, M] -> [K, N, M]."""
    return (A16.float().T @ torch.tril(L16.float())).to(torch.bfloat16)


def check_launch_args(A16, L16):
    _native.require("tril_sq_fwd A16", A16, torch.bfloat16, A16.device)
    _native.require("tril_sq_fwd L16", L16, torch.bfloat16, A16.device)


def tril_sq_fwd(A16, L16):
    """B16[k, n, m'] = bf16(sum_{m >= m'} A16[m, n] L16[k, m, m'])."""
    if A16.ndim != 2 or L16.ndim != 3 or L16.shape[1:] != (A16.shape[0],) * 2:
        raise ValueError(f"tril_sq_fwd: expected [M, N] and [K, M, M], got "
                         f"{tuple(A16.shape)} and {tuple(L16.shape)}")
    if A16.device.type == "cpu":
        return tril_sq_fwd_plain(A16, L16)
    if A16.device.type != "cuda":
        raise ValueError(f"tril_sq_fwd: unsupported device {A16.device}")
    check_launch_args(A16, L16)
    M, N = A16.shape
    K = L16.shape[0]
    B16 = torch.empty((K, N, M), dtype=torch.bfloat16, device=A16.device)
    code = _native.library().mgp_tril_fwd(
        A16.data_ptr(), L16.data_ptr(), B16.data_ptr(), M, N, K,
        _native.stream_ptr(A16.device))
    _native.check(code, "tril_sq_fwd")
    tril_sq_fwd.launches += 1
    return B16


tril_sq_fwd.launches = 0


def atl_sq_colsum(A, L):
    """extra[k, n] = sum_m' (A^T tril L_k)[n, m']^2 with B held in bf16:
    A [M, N], L [K, M, M] (lower triangle read) -> [K, N] fp32."""
    B16 = tril_sq_fwd(A.to(torch.bfloat16).contiguous(),
                      L.to(torch.bfloat16).contiguous())
    return B16.float().square().sum(-1)
