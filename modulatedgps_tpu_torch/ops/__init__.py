"""Kernels, linear algebra and the conditional of the serving slice."""
from .kxz_kernel import kxz
from .tril_kernel import tril_sq_fwd
from .trsm_kernel import trsm_lower

__all__ = ["kxz", "trsm_lower", "tril_sq_fwd", "launch_counts",
           "reset_launch_counts"]

_WRAPPERS = (kxz, trsm_lower, tril_sq_fwd)


def launch_counts() -> dict[str, int]:
    """How many times each CUDA kernel wrapper has launched its kernel."""
    return {fn.__name__: fn.launches for fn in _WRAPPERS}


def reset_launch_counts() -> None:
    for fn in _WRAPPERS:
        fn.launches = 0
