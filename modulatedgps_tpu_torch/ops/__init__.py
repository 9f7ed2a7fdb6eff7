"""Kernels, linear algebra, the conditional, sampling and the KL."""
from .kxz_kernel import kxz
from .tril_kernel import tril_sq_da, tril_sq_dl, tril_sq_fwd
from .trimm_kernel import tri_nt_matmul, tri_tt_matmul
from .trsm_kernel import trsm_lower

__all__ = ["kxz", "trsm_lower", "tril_sq_fwd", "tril_sq_dl", "tril_sq_da",
           "tri_tt_matmul", "tri_nt_matmul", "launch_counts",
           "reset_launch_counts"]

_WRAPPERS = (kxz, trsm_lower, tril_sq_fwd, tril_sq_dl, tril_sq_da,
             tri_tt_matmul, tri_nt_matmul)


def launch_counts() -> dict[str, int]:
    """How many times each CUDA kernel wrapper has launched its kernel."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
