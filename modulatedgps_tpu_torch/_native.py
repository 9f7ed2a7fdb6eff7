"""Build and load the package's CUDA kernels (csrc/*.cu).

The sources are compiled by ``nvcc`` for ``sm_90a`` (Hopper), one process
per source started together, and linked into one shared library with a
plain C interface, loaded with ``ctypes``.  The build happens on first use,
never at import, into ``_build/`` beside this file, under a name keyed by a
hash of the sources and flags, so a changed source rebuilds and an
unchanged one loads the cached library.  A failed build raises with the
compiler's output; there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["library", "build", "check", "require", "stream_ptr"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points: (argtypes) -> int cudaError_t.
_SIGNATURES = {
    "mgp_kxz": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mgp_trsm_lower": (_P, _P, _P, _P, _I, _I, _I, _I, _P),
    "mgp_trsm_lower_t": (_P, _P, _P, _P, _I, _I, _I, _P),
    "mgp_tril_fwd": (_P, _P, _P, _I, _I, _I, _P),
    "mgp_tril_fwd_f32": (_P, _P, _P, _I, _I, _I, _P),
    "mgp_tril_dl": (_P, _P, _P, _P, _I, _I, _I, _P),
    "mgp_tril_da": (_P, _P, _P, _P, _I, _I, _I, _P),
    "mgp_tril_dl_w": (_P, _P, _P, _I, _I, _I, _P),
    "mgp_tril_da_w": (_P, _P, _P, _I, _I, _I, _P),
    "mgp_tri_tt": (_P, _P, _P, _I, _I, _P),
    "mgp_tri_nt": (_P, _P, _P, _I, _P),
    "mgp_kl_fwd": (_P, _P, _P, _I, _I, _P),
    "mgp_kl_bwd": (_P, _P, _P, _I, _I, _P),
    "mgp_adam_tril": (_P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _F, _F, _F, _F,
                      _P),
    "mgp_cholesky": (_P, _P, _P, _I, _P),
    "mgp_qsqrt_sq_colsum": (_P, _P, _P, _I, _I, _I, _P),
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME or /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def build() -> tuple[Path, float]:
    """Compile csrc/*.cu into _build/ if needed; returns (library, seconds).

    seconds is 0.0 when a library for these exact sources already exists.
    """
    sources = sorted(_CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(_FLAGS).encode())
    for path in sorted(_CSRC.glob("*.cu*")):
        digest.update(path.name.encode())
        digest.update(path.read_bytes())
    out = _BUILD / f"libmgp_kernels_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out, 0.0
    _BUILD.mkdir(parents=True, exist_ok=True)
    stem = f"{out.stem}.{os.getpid()}"
    objs = [_BUILD / f"{stem}.{src.stem}.o" for src in sources]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    logs = []                       # (source, compiler output, exit code)
    for src, p in zip(sources, procs):
        output, _ = p.communicate()
        logs.append((src.name, output, p.returncode))
    tmp = _BUILD / f"{stem}.tmp.so"
    link = None
    if all(rc == 0 for *_, rc in logs):
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp),
                               *map(str, objs)], capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    text = "".join(f"== {name}\n{output}" for name, output, _ in logs)
    if link is not None:
        text += f"== link\n{link.stdout}{link.stderr}"
    out.with_suffix(".log").write_text(text)
    for obj in objs:
        obj.unlink(missing_ok=True)
    failed = [name for name, _, rc in logs if rc != 0]
    if failed or link.returncode != 0:
        raise RuntimeError(f"nvcc failed ({failed or 'link'}):\n{text}")
    os.replace(tmp, out)
    return out, seconds


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(code: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{what}: CUDA error {code} at launch")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream


def require(what: str, t, dtype, device) -> None:
    """Argument checks shared by the CUDA wrappers; no card is needed.

    A tensor that requires grad is refused while autograd records (grad
    mode on): a raw launcher records no gradient, so a caller that wants
    one goes through the autograd Function around it (``kxz``,
    ``atl_sq_colsum``, ``atl_matmul``, ``whiten_solve``, ``solve_lower``,
    ``cholesky``, ``qsqrt_sq_colsum``), whose forward and backward launch
    with grad mode off.
    Under torch.inference_mode() or torch.no_grad() nothing is recorded, so
    a trainable parameter may feed them."""
    import torch
    if t.requires_grad and torch.is_grad_enabled():
        raise NotImplementedError(
            f"{what}: the raw CUDA launcher records no gradient; call it "
            "through its autograd Function (kxz, atl_sq_colsum, atl_matmul, "
            "whiten_solve, solve_lower, cholesky, qsqrt_sq_colsum) or under "
            "torch.no_grad()")
    if t.dtype != dtype:
        raise TypeError(f"{what}: expected {dtype}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{what}: expected a tensor on {device}, got {t.device}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: expected a contiguous tensor")
