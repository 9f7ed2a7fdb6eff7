"""Dense linear algebra of the conditional.

Mirrors modulatedgps_tpu/ops/linalg.py.  The factor and the triangular
inverse and solves go through the port's kernels at every M, with no TPU
routing threshold: ``chol_kernel.cholesky_factor`` (the blocked Cholesky,
which also returns the inverses of L's 64x64 diagonal blocks) and
``trsm_kernel.trsm_lower`` / ``trsm_lower_t`` (the CUDA kernels on the card,
their plain versions on the CPU).  Three autograd Functions:

- ``cholesky``: Murray's pullback as linalg._chol_fast_bwd computes it
  (linalg.py:366-399), with L^-1 from the TRSM inverse fed the factor's
  diagonal-block inverses and the banded products of
  trimm_kernel.chol_pullback_structured;
- ``solve_lower``: exact blocked substitution, L^-1 B or L^-T B, with the
  pullback of pallas_linalg.solve_triangular_blocked (:499-510), whose
  B-cotangent is the other-way solve; both take the factor's diagonal-block
  inverses when the caller has them;
- ``whiten_solve``: the whitened feature map A = chol(Kmm)^-1 Kmn formed as
  Linv @ Kmn, the JAX package's fast-solves form (one substitution for the
  [M, M] inverse, then one large matmul), with its composite pullback
  (linalg.py:246-330), which reuses the forward's Linv and closes with the
  banded Cholesky pullback.
"""
from __future__ import annotations

import torch

from .chol_kernel import cholesky_factor
from .trimm_kernel import chol_pullback_structured
from .trsm_kernel import trsm_lower, trsm_lower_t

__all__ = ["cholesky", "cholesky_with_inv", "add_jitter",
           "triangular_inverse", "solve_lower", "whiten_solve"]


def cholesky(K: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of an SPD [M, M] matrix, row-major with exact
    zeros above the diagonal, with Murray's pullback."""
    return _Cholesky.apply(K)[0]


def cholesky_with_inv(K: torch.Tensor):
    """(L, Inv): ``cholesky`` and the inverses of L's diagonal blocks (no
    gradient), which ``triangular_inverse(L, Inv)`` takes."""
    return _Cholesky.apply(K)


class _Cholesky(torch.autograd.Function):
    """Kbar = sym(L^-T phi(L^T Lbar) L^-1), phi = tril with a halved
    diagonal.  Lbar's upper triangle is never read: L is lower-triangular,
    so only the lower triangle of a cotangent reaches K."""

    @staticmethod
    def forward(ctx, K):
        L, Inv = cholesky_factor(K.contiguous())
        ctx.mark_non_differentiable(Inv)
        ctx.save_for_backward(L, Inv)
        return L, Inv

    @staticmethod
    def backward(ctx, Lbar, _):
        L, Inv = ctx.saved_tensors
        return chol_pullback_structured(L, triangular_inverse(L, Inv),
                                        Lbar.contiguous())


def add_jitter(K: torch.Tensor, jitter: float) -> torch.Tensor:
    m = K.shape[-1]
    return K + jitter * torch.eye(m, dtype=K.dtype, device=K.device)


def triangular_inverse(L: torch.Tensor, inv=None) -> torch.Tensor:
    """L^-1 of a lower-triangular [M, M] matrix; ``inv``, the inverses of
    its diagonal blocks from ``cholesky_with_inv``, saves recomputing them."""
    return trsm_lower(L, inv=inv)


def solve_lower(L: torch.Tensor, B: torch.Tensor, *, trans: bool = False,
                inv=None) -> torch.Tensor:
    """L^-1 B, or L^-T B with ``trans``, by blocked substitution,
    differentiable in L and B.  L [M, M] (upper triangle ignored); B
    [M, Nb], or [K, M, Nb], solved as one [M, K*Nb] right side.  ``inv``,
    the inverses of L's diagonal blocks from ``cholesky_with_inv``, saves
    recomputing them in the solve and in its pullback."""
    if B.ndim == 3:
        K, M, Nb = B.shape
        X = _SolveLower.apply(L, B.permute(1, 0, 2).reshape(M, K * Nb), trans,
                              inv)
        return X.reshape(M, K, Nb).permute(1, 0, 2)
    return _SolveLower.apply(L, B, trans, inv)


class _SolveLower(torch.autograd.Function):
    """X = op(L)^-1 B:  Bbar = op(L)^-T Xbar (the other-way solve);
    Lbar = -tril(Bbar X^T) for op = I, -tril(X Bbar^T) for op = T.  The
    [M, Nb] x [Nb, M] product stays a plain fp32 matmul, as JAX leaves it
    to XLA."""

    @staticmethod
    def forward(ctx, L, B, trans, inv):
        X = (trsm_lower_t if trans else trsm_lower)(L, B.contiguous(), inv=inv)
        ctx.trans = trans
        ctx.save_for_backward(L, X, inv)
        return X

    @staticmethod
    def backward(ctx, Xbar):
        L, X, inv = ctx.saved_tensors
        Xbar = Xbar.contiguous()
        Bbar = (trsm_lower if ctx.trans else trsm_lower_t)(L, Xbar, inv=inv)
        Lbar = None
        if ctx.needs_input_grad[0]:
            G = X @ Bbar.T if ctx.trans else Bbar @ X.T
            Lbar = torch.tril(G).neg_()
        return Lbar, Bbar if ctx.needs_input_grad[1] else None, None, None


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
        L, Inv = cholesky_with_inv(Kmm)
        Linv = triangular_inverse(L, Inv)
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
