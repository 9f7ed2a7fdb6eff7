"""(L, Inv) = the lower Cholesky factor of an SPD [M, M] matrix and the
inverses of its diagonal blocks: the CUDA kernel and its plain version.

Replaces modulatedgps_tpu/ops/pallas_linalg.py:_chol_kernel (M <= 1024,
reached there through cholesky_blocked) and _chol_kernel_large (the M=4096
variant, _chol_pallas_large); on the TPU they were two kernels only because
of VMEM.  The kernel is csrc/chol.cu: a right-looking blocked factorization
with 64-wide blocks in fp32 FMAs, one C call and three launches per
factorization: a copy, one persistent kernel that runs the 64x64 tile tasks,
then trsm.cu's diagonal-block inverse on the finished L.  In the persistent
kernel one CTA runs the chain (for each block column: solve the panel tile
beside the diagonal, update the diagonal tile, factor it in blocks of 16
columns, keep the factor in shared memory for the next link) while the
others take the remaining panel solves P_ij L_jj^T = A_ij (by
substitution: the TPU kernel's A_ij Inv_j^T loses accuracy on an
ill-conditioned Kmm such as the assignment layer's) and trailing updates
A_ik -= P_ij P_kj^T in a fixed order with a lookahead of one block column,
each task waiting on per-tile counters for its inputs.  Its critical path
is the chain, 64 links at M=4096.  The work buffer holds the task counter
and the per-tile counters; the copy kernel zeroes it.

L is row-major with exact zeros above the diagonal.  Inv is [ceil(M/64),
64, 64], the last block of a ragged M padded with the identity: trsm.cu's
first launch, run once here, so ``trsm_lower(L, B, inv=Inv)`` and
``trsm_lower_t(L, B, inv=Inv)`` skip it (the JAX package's
``_trsm_pallas_raw(L, Inv, B)``).  A pivot that is not positive gives NaN from its column on, as
``jnp.linalg.cholesky`` gives NaN; nothing raises and nothing reads an
info code back to the host.

``cholesky_factor`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  Every launch adds one to
``cholesky_factor.launches``.
"""
from __future__ import annotations

import torch

from .. import _native
from .trsm_kernel import BLOCK

__all__ = ["cholesky_factor", "cholesky_factor_plain", "check_launch_args",
           "trace_summary", "TRACE_INIT", "DIAG_PARTS"]


def cholesky_factor_plain(K, block=BLOCK):
    """The same blocked loop in torch ops, in K's dtype: per diagonal tile
    torch.linalg.cholesky_ex (NaN from the first failed column on) and a
    triangular solve for its inverse; the panel P_ij L_jj^T = A_ij by a
    triangular solve; the trailing update P P^T.  ``block`` is free so that
    Inv can be held against the JAX kernel's 128-blocks."""
    M = K.shape[-1]
    nblk = (M + block - 1) // block
    Mp = nblk * block
    A = torch.eye(Mp, dtype=K.dtype, device=K.device)
    A[:M, :M] = torch.tril(K)
    Inv = torch.empty((nblk, block, block), dtype=K.dtype, device=K.device)
    eye = torch.eye(block, dtype=K.dtype, device=K.device)
    cols = torch.arange(block, device=K.device)
    for j in range(nblk):
        d = slice(j * block, (j + 1) * block)
        Ljj, info = torch.linalg.cholesky_ex(A[d, d])
        failed = (info > 0) & (cols >= info - 1)
        Ljj = torch.where(failed, torch.nan, Ljj)
        Inv[j] = torch.linalg.solve_triangular(Ljj, eye, upper=False)
        A[d, d] = Ljj
        if j + 1 < nblk:
            below = slice((j + 1) * block, Mp)
            P = torch.linalg.solve_triangular(Ljj.T, A[below, d],
                                              upper=True, left=False)
            A[below, d] = P
            A[below, below] -= P @ P.T
    return torch.tril(A[:M, :M]), Inv


def check_launch_args(K):
    _native.require("cholesky_factor K", K, torch.float32, K.device)


def cholesky_factor(K, trace=None):
    """(L, Inv) of an SPD [M, M] matrix (lower triangle read): L [M, M]
    with exact zeros above the diagonal, Inv [ceil(M/64), 64, 64].

    ``trace``, for measurement only: a CUDA int64 tensor of 12 entries,
    set to ``TRACE_INIT`` before the call, into which the task-graph kernel
    adds its nanoseconds (summed over CTAs) of waiting, of diagonal-tile,
    panel and update work, the three task counts, its first start and last
    end on the device clock, and the diagonal-tile work in its three parts
    (``trace_summary`` reads it)."""
    if K.ndim != 2 or K.shape[0] != K.shape[1]:
        raise ValueError(f"cholesky_factor: K must be [M, M], got "
                         f"{tuple(K.shape)}")
    if K.device.type == "cpu":
        return cholesky_factor_plain(K)
    if K.device.type != "cuda":
        raise ValueError(f"cholesky_factor: unsupported device {K.device}")
    check_launch_args(K)
    M = K.shape[0]
    nblk = (M + BLOCK - 1) // BLOCK
    L = torch.empty((M, M), dtype=torch.float32, device=K.device)
    Inv = torch.empty((nblk, BLOCK, BLOCK), dtype=torch.float32,
                      device=K.device)
    work = torch.empty(1 + nblk * nblk, dtype=torch.int32, device=K.device)
    code = _native.library().mgp_cholesky(
        K.data_ptr(), L.data_ptr(), Inv.data_ptr(), work.data_ptr(),
        None if trace is None else trace.data_ptr(), M,
        _native.stream_ptr(K.device))
    _native.check(code, "cholesky_factor")
    cholesky_factor.launches += 1
    return L, Inv


cholesky_factor.launches = 0

# A trace's initial value: 7 zero sums, the first start at the largest
# uint64 (as int64 bits), the last end at 0, then 3 zero sums.
TRACE_INIT = (0,) * 7 + (-1, 0) + (0,) * 3

# The diagonal-tile task's parts: the solve of the panel tile beside it,
# the product P P^T, and the tile's factor.
DIAG_PARTS = ("diag_solve", "diag_product", "diag_factor")


def trace_summary(trace):
    """{"span_ms", "wait_ms", "diag_ms", "panel_ms", "update_ms" and the
    DIAG_PARTS' "*_ms" (CTA-ms summed over the CTAs), "diag", "panel",
    "update" (task counts)} of a trace filled by cholesky_factor."""
    t = [int(v) % 2**64 for v in trace.tolist()]
    out = {"span_ms": (t[8] - t[7]) / 1e6}
    out.update({f"{name}_ms": t[q] / 1e6
                for q, name in enumerate(("wait", "diag", "panel", "update"))})
    out.update({name: t[4 + q] for q, name in enumerate(("diag", "panel",
                                                         "update"))})
    out.update({f"{name}_ms": t[9 + q] / 1e6
                for q, name in enumerate(DIAG_PARTS)})
    return out
