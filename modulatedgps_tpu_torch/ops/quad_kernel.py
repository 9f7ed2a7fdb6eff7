"""extra[k, n] = sum_p (tril(S_k)^T A)[p, n]^2 from bf16 operands, the square
and the sum fused into the kernel: the CUDA kernel, its plain version and
the autograd Function around them.

Replaces modulatedgps_tpu/ops/pallas_quad.py:_quad_kernel, reached there
through qsqrt_sq_colsum.  It is tril_kernel.atl_sq_colsum's function, but
the [K, N, M] product never reaches memory and is squared from its fp32
accumulators (where atl_sq_colsum first rounds it to bf16, because its
backward kernels read it): the served variance's |S_k^T a|^2, where no
backward is asked for.  The kernel is csrc/quad.cu: one CUDA block per
(n-tile, k) walks the lower triangle of S_k tile by tile on bf16 wmma
fragments with fp32 accumulators, squares and sums in fp32 in a fixed
order (two runs give the same bits).  The TPU's MAX_M (VMEM) gate does not
carry over.

The backward is JAX's _quad_bwd (pallas_quad.py:120-130): recompute
tril(S)^T A, W = 2 g S^T A, dA = sum_k S_k W_k, dS = tril(A W^T), as plain
matmuls in the inputs' dtype, as JAX leaves them to XLA.

``qsqrt_sq_colsum`` takes the plain version only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  Every launch adds one to
``qsqrt_sq_colsum.launches``.
"""
from __future__ import annotations

import torch

from .. import _native

__all__ = ["qsqrt_sq_colsum", "qsqrt_sq_colsum_plain", "check_launch_args"]


def qsqrt_sq_colsum_plain(S, A):
    """JAX's qsqrt_sq_colsum_xla on bf16-rounded operands, fp32
    accumulation: S [K, M, M], A [M, N] -> [K, N] fp32."""
    S32 = torch.tril(S.to(torch.bfloat16).float())
    return (S32.transpose(-1, -2) @ A.to(torch.bfloat16).float()).square().sum(-2)


def check_launch_args(S16, A16):
    _native.require("qsqrt_sq_colsum S16", S16, torch.bfloat16, A16.device)
    _native.require("qsqrt_sq_colsum A16", A16, torch.bfloat16, A16.device)


def _sq_colsum(S16, A16):
    """The kernel on CUDA tensors, the plain version on CPU tensors."""
    if A16.device.type == "cpu":
        return qsqrt_sq_colsum_plain(S16, A16)
    if A16.device.type != "cuda":
        raise ValueError(f"qsqrt_sq_colsum: unsupported device {A16.device}")
    check_launch_args(S16, A16)
    K, M, _ = S16.shape
    N = A16.shape[1]
    out = torch.zeros((K, N), dtype=torch.float32, device=A16.device)
    code = _native.library().mgp_qsqrt_sq_colsum(
        S16.data_ptr(), A16.data_ptr(), out.data_ptr(), M, N, K,
        _native.stream_ptr(A16.device))
    _native.check(code, "qsqrt_sq_colsum")
    qsqrt_sq_colsum.launches += 1
    return out


class _QsqrtSqColsum(torch.autograd.Function):

    @staticmethod
    def forward(ctx, S, A):
        ctx.save_for_backward(S, A)
        S16 = S.to(torch.bfloat16).contiguous()
        A16 = A.to(torch.bfloat16).contiguous()
        return _sq_colsum(S16, A16).to(A.dtype)

    @staticmethod
    def backward(ctx, g):
        S, A = ctx.saved_tensors
        St = torch.tril(S).to(A.dtype)
        W = 2.0 * g[:, None, :] * (St.transpose(-1, -2) @ A)      # [K, M, N]
        dA = (St @ W).sum(0) if ctx.needs_input_grad[1] else None
        dS = None
        if ctx.needs_input_grad[0]:
            dS = torch.tril(A @ W.transpose(-1, -2)).to(S.dtype)
        return dS, dA


def qsqrt_sq_colsum(S, A):
    """extra[k, n] = sum_p (tril(S_k)^T A)[p, n]^2: S [K, M, M] (only the
    lower triangle is read; bf16 or any float type, cast to bf16), A [M, N]
    -> [K, N] in A's dtype, differentiable in both."""
    if S.ndim != 3 or A.ndim != 2 or S.shape[1:] != (A.shape[0],) * 2:
        raise ValueError(f"qsqrt_sq_colsum: expected S [K, M, M] and A [M, N], "
                         f"got {tuple(S.shape)} and {tuple(A.shape)}")
    return _QsqrtSqColsum.apply(S, A)


qsqrt_sq_colsum.launches = 0
