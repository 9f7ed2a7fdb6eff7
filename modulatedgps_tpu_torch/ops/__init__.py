"""Kernels, linear algebra, the conditional, sampling and the KL."""
from ..training.fused_adam import adam_tril_
from .chol_kernel import cholesky_factor
from .kl_kernel import kl_bwd_scale, kl_sq_logdiag
from .kxz_kernel import kxz
from .quad_kernel import qsqrt_sq_colsum
from .tril_kernel import (tril_da, tril_dl, tril_fwd_f32, tril_sq_da,
                          tril_sq_dl, tril_sq_fwd)
from .trimm_kernel import tri_nt_matmul, tri_tt_matmul
from .trsm_kernel import trsm_lower, trsm_lower_t

__all__ = ["kxz", "trsm_lower", "tril_sq_fwd", "trsm_lower_t", "tril_fwd_f32",
           "tril_dl", "tril_da", "tril_sq_dl", "tril_sq_da", "tri_tt_matmul",
           "tri_nt_matmul", "kl_sq_logdiag", "kl_bwd_scale", "adam_tril_",
           "cholesky_factor", "qsqrt_sq_colsum", "launch_counts",
           "reset_launch_counts"]

# Every CUDA kernel wrapper, in the order of the kernels' table in PERF.md.
_WRAPPERS = (kxz, trsm_lower, tril_sq_fwd, trsm_lower_t, tril_fwd_f32,
             tril_dl, tril_da, tril_sq_dl, tril_sq_da, tri_tt_matmul,
             tri_nt_matmul, kl_sq_logdiag, kl_bwd_scale, adam_tril_,
             cholesky_factor, qsqrt_sq_colsum)


def launch_counts() -> dict[str, int]:
    """How many times each CUDA kernel wrapper has launched its kernel."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
