"""Banded triangular products for the Cholesky pullback: the CUDA kernels
and their plain versions.

Replaces modulatedgps_tpu/ops/pallas_trimm.py:_k_tt (tri_tt_matmul) and
_k_nt (tri_nt_matmul).  Murray's pullback of L = chol(K),

    P    = L^T Lbar            (only tril(P) is used)
    phi  = tril(P) - 0.5 diag(P)
    Kbar = sym(Linv^T phi Linv),

has only triangular operands, so each M^3 product is banded:
``tri_tt_matmul`` (C = tril(A)^T tril(B), contraction k >= max(i, j)) and
``tri_nt_matmul`` (C = A tril(B), contraction k >= j), ~M^3 multiply-adds
for the three products instead of 3 M^3.

The kernels are csrc/trimm.cu.  Precision is the trap: the pullback
cancels catastrophically (a single bf16 pass gave 631x worse Z gradients,
CHOLPREC_GRADERR_r04.json), so float32 products are the 3-pass bf16 split
of pallas_trimm._dot3 -- x = hi + lo, hi the bf16 with x's low 16 bits
masked off, lo = bf16(x - hi), and hi*hi + hi*lo + lo*hi accumulated in
fp32 -- on the card and in the plain versions alike.  A float64 product
(the CPU reference) is taken exactly.

``tri_tt_matmul`` and ``tri_nt_matmul`` take the plain version only for
CPU tensors; for CUDA tensors they launch the kernel or raise.  Every
launch adds one to the wrapper's ``launches``.  L and Linv must be
row-major (ops/linalg.cholesky writes its factor so).
"""
from __future__ import annotations

import torch

from .. import _native

__all__ = ["tri_tt_matmul", "tri_tt_matmul_plain", "tri_nt_matmul",
           "tri_nt_matmul_plain", "chol_pullback_structured",
           "chol_pullback_dense", "split_bf16", "check_launch_args"]


def split_bf16(x):
    """(hi, lo) bf16 split of float32 x: hi masks off the low 16 bits
    (exactly a bf16, x - hi exact in f32), lo = bf16(x - hi)."""
    hi = (x.view(torch.int32) & -65536).view(torch.float32)
    return hi.to(torch.bfloat16), (x - hi).to(torch.bfloat16)


def _dot(a, b):
    """a @ b: the 3-pass split with fp32 accumulation for float32, exact
    otherwise."""
    if a.dtype != torch.float32:
        return a @ b
    ah, al = (t.float() for t in split_bf16(a))
    bh, bl = (t.float() for t in split_bf16(b))
    return ah @ bh + ah @ bl + al @ bh


def tri_tt_matmul_plain(A, B, *, tril_out: bool):
    C = _dot(torch.tril(A).T, torch.tril(B))
    return torch.tril(C) if tril_out else C


def tri_nt_matmul_plain(A, B):
    return _dot(A, torch.tril(B))


def check_launch_args(what, A, B):
    _native.require(f"{what} A", A, torch.float32, A.device)
    _native.require(f"{what} B", B, torch.float32, A.device)


def _square_pair(what, A, B):
    if A.ndim != 2 or A.shape[0] != A.shape[1] or B.shape != A.shape:
        raise ValueError(f"{what}: expected two [M, M] matrices, got "
                         f"{tuple(A.shape)} and {tuple(B.shape)}")
    if A.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {A.device}")
    return A.shape[0]


def tri_tt_matmul(A, B, *, tril_out: bool):
    """C = tril(A)^T tril(B) for [M, M] A, B (upper triangles ignored);
    with ``tril_out`` exactly the lower triangle of C (zeros above)."""
    M = _square_pair("tri_tt_matmul", A, B)
    if A.device.type == "cpu":
        return tri_tt_matmul_plain(A, B, tril_out=tril_out)
    check_launch_args("tri_tt_matmul", A, B)
    C = torch.empty((M, M), dtype=torch.float32, device=A.device)
    code = _native.library().mgp_tri_tt(A.data_ptr(), B.data_ptr(),
                                        C.data_ptr(), M, int(tril_out),
                                        _native.stream_ptr(A.device))
    _native.check(code, "tri_tt_matmul")
    tri_tt_matmul.launches += 1
    return C


def tri_nt_matmul(A, B):
    """C = A tril(B) for dense [M, M] A and [M, M] B (upper triangle
    ignored)."""
    M = _square_pair("tri_nt_matmul", A, B)
    if A.device.type == "cpu":
        return tri_nt_matmul_plain(A, B)
    check_launch_args("tri_nt_matmul", A, B)
    C = torch.empty((M, M), dtype=torch.float32, device=A.device)
    code = _native.library().mgp_tri_nt(A.data_ptr(), B.data_ptr(),
                                        C.data_ptr(), M,
                                        _native.stream_ptr(A.device))
    _native.check(code, "tri_nt_matmul")
    tri_nt_matmul.launches += 1
    return C


tri_tt_matmul.launches = 0
tri_nt_matmul.launches = 0


def chol_pullback_dense(L, Linv, Lbar):
    """Murray (2016) eq. 8-9 as dense products (pallas_trimm.py:233-244):
    the oracle of the structured form."""
    P = L.T @ Lbar
    phi = torch.tril(P) - 0.5 * torch.diag_embed(torch.diagonal(P))
    Kbar = Linv.T @ phi @ Linv
    return 0.5 * (Kbar + Kbar.T)


def chol_pullback_structured(L, Linv, Lbar):
    """The same pullback on the banded products (pallas_trimm.py:247-256):
    L, Linv, Lbar [M, M] lower-triangular (upper triangles ignored)."""
    P = tri_tt_matmul(L, Lbar, tril_out=True)      # exactly lower
    P.diagonal().mul_(0.5)                         # phi = tril(P) - 0.5 diag
    S1 = tri_tt_matmul(Linv, P, tril_out=False)
    Kraw = tri_nt_matmul(S1, Linv)
    return 0.5 * (Kraw + Kraw.T)
