"""Dense linear algebra of the conditional.

Mirrors modulatedgps_tpu/ops/linalg.py.  ``torch.linalg.cholesky`` takes
the place of ``jnp.linalg.cholesky``; the triangular inverse and solves go
through ``trsm_kernel.trsm_lower`` (the CUDA kernel on the card, its plain
version on the CPU) at every M, with no TPU routing threshold.  The
whitened feature map A = chol(Kmm)^-1 Kmn is formed as Linv @ Kmn, the JAX
package's fast-solves form: one substitution for the [M, M] inverse, then
one large matmul.  ``whiten_solve`` is an autograd Function with the JAX
package's composite pullback (linalg.py:246-330), which reuses the
forward's Linv and closes with the banded Cholesky pullback
(trimm_kernel.chol_pullback_structured).
"""
from __future__ import annotations

import torch

from .trimm_kernel import chol_pullback_structured
from .trsm_kernel import trsm_lower

__all__ = ["cholesky", "add_jitter", "triangular_inverse", "solve_lower",
           "whiten_solve"]


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of an SPD matrix, row-major.

    On CUDA, torch.linalg.cholesky returns the factor column-major (the
    solver's layout); the kernels take row-major tensors, so it is copied
    once here ([M, M], small next to the work that reads it)."""
    return torch.linalg.cholesky(K).contiguous()


def add_jitter(K: torch.Tensor, jitter: float) -> torch.Tensor:
    m = K.shape[-1]
    return K + jitter * torch.eye(m, dtype=K.dtype, device=K.device)


def triangular_inverse(L: torch.Tensor) -> torch.Tensor:
    """L^-1 of a lower-triangular [M, M] matrix."""
    return trsm_lower(L)


def solve_lower(L: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """L^-1 B by blocked substitution (the transposed solve waits for the
    port of pallas_linalg._trsm_t_kernel)."""
    return trsm_lower(L, B)


def whiten_solve(Kmm: torch.Tensor, Kmn: torch.Tensor) -> torch.Tensor:
    """A = chol(Kmm)^-1 Kmn: Cholesky, kernel inverse, one matmul
    (modulatedgps_tpu/ops/linalg.py:287-297), differentiable in both."""
    return _WhitenSolve.apply(Kmm, Kmn)


class _WhitenSolve(torch.autograd.Function):
    """The solve pullback without differentiating the inverse:

        Kmn_bar = Linv^T Abar
        Lbar    = -tril(Kmn_bar A^T)
        Kmm_bar = chol_pullback(L, Linv, Lbar)

    The two [M, N] x [N, M]-class products stay plain fp32 matmuls, as JAX
    leaves them to XLA; the M^3 products go through the banded kernels."""

    @staticmethod
    def forward(ctx, Kmm, Kmn):
        L = cholesky(Kmm)
        Linv = triangular_inverse(L)
        A = Linv @ Kmn
        ctx.save_for_backward(L, Linv, A)
        return A

    @staticmethod
    def backward(ctx, Abar):
        L, Linv, A = ctx.saved_tensors
        Kmn_bar = Linv.T @ Abar
        Kmm_bar = None
        if ctx.needs_input_grad[0]:
            Lbar = torch.tril(Kmn_bar @ A.T).neg_()
            Kmm_bar = chol_pullback_structured(L, Linv, Lbar)
        return Kmm_bar, Kmn_bar
