"""The operations each kernel wrapper stands for, for
``utils.profiling.flops_estimate``.

``torch.utils.flop_counter.FlopCounterMode`` sees aten ops only: a
hand-written kernel launched through ctypes is invisible to it.  So
``flops_estimate`` counts each wrapper by the function of the same name
here, called with the wrapper's own arguments.  The wrappers themselves
carry no count.

Where the JAX package hands the same operands to its Pallas kernel, the
count is the ``flops`` of the ``pl.CostEstimate`` that call declares, at
the padded shapes and the block size the call uses:

- K(X, Z), ``pallas_kernels.py:118``: 2·Np·Mp·Dp + 6·Np·Mp with N and M
  padded to 256 and D to 128;
- the tril family #3, #5-#9, ``pallas_tril.py:215,264,318,448,497,549``:
  K·M·(M + BM)·Np with BM 512 (256 where 512 does not divide M) and N
  padded to 1024; the 3-pass split forward three times #3's;
- the Cholesky #15/#16, ``pallas_linalg.py:283,303``: Mp³/3 with M padded
  to 128;
- the TRSM #2/#4, ``pallas_linalg.py:397``: Mp²·Np with M padded to 128
  and the right side's columns (M for the inverse) to 512;
- #10/#11, ``pallas_trimm.py:173,224``: 6·BM³ for each block product of
  their schedules (``_steps_tt`` / ``_steps_nt``);
- #12/#13, ``pallas_kl.py:99,149``: 3·K·M²/2 and K·M²;
- #14, ``training/fused_adam.py:128``: 10·K·M²/2;
- #17, ``pallas_quad.py:87``: 2·K·M²·N (unpadded).

The tril family and the KL and Adam kernels take only an M of at least
2048 that 256 divides (``pallas_tril.eligible``, ``pallas_kl.eligible``,
``fused_adam._eligible``), the trimm pair only an M that 256 divides
(``pallas_trimm.eligible``).  At any other M the JAX package makes no
Pallas call: it runs XLA's dense op, and the count is that op's
contraction as XLA's cost analysis gives it (2·K·M²·N for the tril family,
2·M³ for a trimm product) and 0 for the KL's and Adam's element-wise
updates, as FlopCounterMode counts no element-wise aten op either.  K(X,
Z)'s pullback always runs on XLA (``pallas_kernels.py:155``): its count is
the contractions of that pullback, 2·N·M·D for the recomputed cross term
and 2·N·M·D for each of X̄ and Z̄ asked for.
"""
from __future__ import annotations

__all__ = ["FLOPS"]

MIN_M = 2048      # the tril family's, the KL's and the Adam's least M


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def _block(M: int) -> int:
    """The Pallas block size for M, 0 where neither 512 nor 256 divides M."""
    for bm in (512, 256):
        if M % bm == 0:
            return bm
    return 0


def _tril_block(M: int) -> int:
    return _block(M) if M >= MIN_M else 0


def _tril(K: int, M: int, N: int) -> int:
    bm = _tril_block(M)
    if not bm:
        return 2 * K * M * M * N
    return K * M * (M + bm) * _round_up(N, 1024)


def kxz(X, X2, *_, **__) -> int:
    (N, D), M = X.shape, X2.shape[0]
    Np, Mp, Dp = _round_up(N, 256), _round_up(M, 256), _round_up(D, 128)
    return 2 * Np * Mp * Dp + 6 * Np * Mp


def kxz_vjp(X, X2, lengthscales, variance, Kbar, *, kind="rbf",
            needs=(True, True, True, True)) -> int:
    if not any(needs):
        return 0
    (N, D), M = X.shape, X2.shape[0]
    return 2 * N * M * D * (1 + bool(needs[0]) + bool(needs[1]))


def trsm_lower(L, B=None, **_) -> int:
    M = L.shape[0]
    Nb = M if B is None else B.shape[1]
    return _round_up(M, 128) ** 2 * _round_up(Nb, 512)


def trsm_lower_t(L, B, **_) -> int:
    return trsm_lower(L, B)


def tril_sq_fwd(A16, L16) -> int:
    return _tril(L16.shape[0], *A16.shape)


def tril_sq_fwd_split(A2, L2) -> int:
    K, (M, N) = L2.shape[0] // 2, A2.shape[1:]
    return _tril(K, M, N) * (3 if _tril_block(M) else 1)


def tril_dl(A16, W16) -> int:
    return _tril(W16.shape[0], *A16.shape)


def tril_da(L16, W16) -> int:
    return _tril(L16.shape[0], L16.shape[1], W16.shape[1])


def tril_sq_dl(A16, B16, G) -> int:
    return _tril(B16.shape[0], *A16.shape)


def tril_sq_da(L16, B16, G) -> int:
    return _tril(L16.shape[0], L16.shape[1], B16.shape[1])


def tri_tt_matmul(A, B, *, tril_out: bool) -> int:
    M = A.shape[-1]
    bm = _block(M)
    if not bm:
        return 2 * M ** 3
    nb = M // bm
    steps = sum(nb - max(bi, bj) for bi in range(nb) for bj in range(nb)
                if not (tril_out and bi < bj))
    return 6 * steps * bm ** 3


def tri_nt_matmul(A, B) -> int:
    M = A.shape[-1]
    bm = _block(M)
    if not bm:
        return 2 * M ** 3
    nb = M // bm
    return 6 * nb * (nb * (nb + 1) // 2) * bm ** 3


def kl_sq_logdiag(Lq) -> int:
    K, M = Lq.shape[0], Lq.shape[-1]
    return 3 * K * M * M // 2 if _tril_block(M) else 0


def kl_bwd_scale(Lq, g) -> int:
    K, M = Lq.shape[0], Lq.shape[-1]
    return K * M * M if _tril_block(M) else 0


def adam_tril_(p, *_, **__) -> int:
    K, M = p.shape[0], p.shape[-1]
    return 10 * K * M * M // 2 if _tril_block(M) else 0


def cholesky_factor(K, trace=None) -> int:
    return _round_up(K.shape[0], 128) ** 3 // 3


def qsqrt_sq_colsum(S, A) -> int:
    K, M, _ = S.shape
    return 2 * K * M * M * A.shape[1]


# Each kernel wrapper's count, by the wrapper's name.
FLOPS = {f.__name__: f for f in (
    kxz, kxz_vjp, trsm_lower, trsm_lower_t, tril_sq_fwd, tril_sq_fwd_split,
    tril_dl, tril_da, tril_sq_dl, tril_sq_da, tri_tt_matmul, tri_nt_matmul,
    kl_sq_logdiag, kl_bwd_scale, adam_tril_, cholesky_factor,
    qsqrt_sq_colsum)}
FLOPS["tril_fwd_f32"] = tril_sq_fwd
