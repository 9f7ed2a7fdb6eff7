"""X = L^-1 B and X = L^-T B for lower-triangular L: the CUDA kernels and
their plain versions.

Replaces modulatedgps_tpu/ops/pallas_linalg.py:_trsm_kernel (reached there
through solve_triangular_blocked / solve_triangular_large and
linalg._pallas_trinv) and _trsm_t_kernel (the same calls with
``trans=True``).  The kernels are csrc/trsm.cu.  One launch inverts the
64x64 diagonal blocks; a second walks the block rows of each column strip of
B with fp32 FMAs only (the TPU's fori_loop over row blocks): downwards for
L^-1 B, upwards for L^-T B.  A B of at least ``WIDE_MIN_NB`` columns gives
each 64-column strip its own CUDA block, bound by the shared-memory
bandwidth that feeds its FMAs.  The inverse and a narrower B run as a
wavefront over the whole card: each (block row, strip) is a work item taken
from a ticket counter by a persistent grid, waiting only on the ready flags
of the X blocks above it (``wavefront_order`` gives the tickets' order and
the int32 scratch, zeroed here for each call).  The strips are 64 columns
wide, or 8 for a B narrower than ``NARROW_MAX_NB``.  Every kernel keeps one
FMA order, so all give the same bits.  For the inverse (B = I, ``B=None``) a
strip skips the block rows above its diagonal, and so does the forward solve
with ``tril_rhs=True`` (each run of M columns of B lower-triangular, as the
unwhitened KL's [M, K*M] right side), with the same result.  A caller
holding the Cholesky's diagonal-block inverses (chol_kernel.cholesky_factor,
the JAX package's ``_trsm_pallas_raw(L, Inv, B)``) passes them as ``inv``
and the first launch is skipped.

``trsm_lower`` and ``trsm_lower_t`` take the plain version only for CPU
tensors; for CUDA tensors they launch the kernel or raise.  Every call that
launches adds one to the wrapper's ``launches``.
"""
from __future__ import annotations

import torch

from .. import _native

__all__ = ["trsm_lower", "trsm_lower_plain", "trsm_lower_t",
           "trsm_lower_t_plain", "check_launch_args", "wavefront_order",
           "wavefront_width", "first_block", "BLOCK", "WIDE_MIN_NB",
           "NARROW_MAX_NB"]

BLOCK = 64   # diagonal block size of csrc/trsm.cu
WIDE_MIN_NB = 4096   # csrc/trsm.cu's kWideMinNb: from this width B runs wide
NARROW_MAX_NB = 64   # kNarrowMaxNb: below it a general B takes 8-column strips


def wavefront_width(Nb, unit_rhs):
    """The wavefront's strip width for a right side of Nb columns, or None
    when the wide kernel takes it (csrc/trsm.cu's solve)."""
    if not unit_rhs and Nb >= WIDE_MIN_NB:
        return None
    return 8 if not unit_rhs and Nb < NARROW_MAX_NB else 64


def first_block(c0, w, M, Nb):
    """csrc/trsm.cu's first_block: the first block row a strip of w columns
    from c0 computes when each run of M columns is lower-triangular."""
    lc = c0 % M
    return lc // BLOCK if (lc + w <= M or c0 - lc + M >= Nb) else 0


def _scratch_words(M, Nb, unit_rhs):
    W = wavefront_width(Nb, unit_rhs)
    return 0 if W is None else 1 + -(-M // BLOCK) * -(-Nb // W)


def wavefront_order(M, Nb, unit_rhs=False, tril_rhs=False, trans=False):
    """(items, words): the wavefront kernel's items (block row k, strip s)
    in ticket order, and the int32 words of its scratch (the ticket counter
    and a flag per (k, s)); ([], 0) when the wide kernel runs.  As
    csrc/trsm.cu documents it: walk rows in order (forward k ascending,
    ``trans`` descending), each holding the strips whose first block row is
    at most k (with ``unit_rhs`` or ``tril_rhs`` on the forward walk; else
    every strip), in the order of a stable sort of the strips by that first
    block row."""
    W = wavefront_width(Nb, unit_rhs)
    if W is None:
        return [], 0
    nblk, nstrips = -(-M // BLOCK), -(-Nb // W)
    skip = not trans and (unit_rhs or tril_rhs)
    kstart = [first_block(s * W, W, M, Nb) if skip else 0
              for s in range(nstrips)]
    perm = sorted(range(nstrips), key=lambda s: kstart[s])
    items = []
    for w in range(nblk):
        k = nblk - 1 - w if trans else w
        items += [(k, s) for s in perm if kstart[s] <= k]
    return items, _scratch_words(M, Nb, unit_rhs)


def trsm_lower_plain(L, B=None):
    if B is None:
        B = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    return torch.linalg.solve_triangular(L, B, upper=False)


def trsm_lower_t_plain(L, B):
    return torch.linalg.solve_triangular(L.tril().T, B, upper=True)


def check_launch_args(L, B=None, what="trsm_lower", inv=None):
    _native.require(f"{what} L", L, torch.float32, L.device)
    if B is not None:
        _native.require(f"{what} B", B, torch.float32, L.device)
    if inv is not None:
        _native.require(f"{what} inv", inv, torch.float32, L.device)
        nblk = (L.shape[0] + BLOCK - 1) // BLOCK
        if inv.shape != (nblk, BLOCK, BLOCK):
            raise ValueError(f"{what}: inv must be [{nblk}, {BLOCK}, {BLOCK}], "
                             f"got {tuple(inv.shape)}")


def _check_shapes(what, L, B):
    if L.ndim != 2 or L.shape[0] != L.shape[1]:
        raise ValueError(f"{what}: L must be [M, M], got {tuple(L.shape)}")
    if B is not None and (B.ndim != 2 or B.shape[0] != L.shape[0]):
        raise ValueError(f"{what}: B must be [{L.shape[0]}, Nb], got "
                         f"{tuple(B.shape)}")
    if L.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {L.device}")
    return L.device.type == "cuda"


def _launch(what, L, B, inv, *args):
    """Allocate X, the wavefront's zeroed scratch (and the diagonal-block
    scratch unless ``inv`` is given), launch, check."""
    check_launch_args(L, B, what, inv)
    M = L.shape[0]
    Nb = M if B is None else B.shape[1]
    X = torch.empty((M, Nb), dtype=torch.float32, device=L.device)
    work = torch.zeros(_scratch_words(M, Nb, B is None), dtype=torch.int32,
                       device=L.device)
    given = inv is not None
    if not given:
        inv = torch.empty(((M + BLOCK - 1) // BLOCK, BLOCK, BLOCK),
                          dtype=torch.float32, device=L.device)
    code = getattr(_native.library(), f"mgp_{what}")(
        L.data_ptr(), inv.data_ptr(), None if B is None else B.data_ptr(),
        X.data_ptr(), work.data_ptr(), M, Nb, *args, int(given),
        _native.stream_ptr(L.device))
    _native.check(code, what)
    return X


def trsm_lower(L, B=None, *, inv=None, tril_rhs=False):
    """L^-1 B for L [M, M] (upper triangle ignored) and B [M, Nb]; B=None
    means the identity, i.e. the triangular inverse.  ``inv``
    [ceil(M/64), 64, 64], the inverses of L's diagonal blocks as
    chol_kernel.cholesky_factor returns them, saves the kernel's first
    launch.  ``tril_rhs`` promises that each run of M columns of B is
    lower-triangular (Nb a multiple of M), so the kernel skips the zero
    block rows above each strip's first column; the plain version ignores
    it."""
    cuda = _check_shapes("trsm_lower", L, B)
    M = L.shape[0]
    if tril_rhs and (B is None or M == 0 or B.shape[1] % M != 0):
        raise ValueError(f"trsm_lower: tril_rhs needs B [M, Nb] with Nb a "
                         f"multiple of M={M}, got "
                         f"{None if B is None else tuple(B.shape)}")
    if not cuda:
        return trsm_lower_plain(L, B)
    X = _launch("trsm_lower", L, B, inv, int(B is None), int(tril_rhs))
    trsm_lower.launches += 1
    return X


def trsm_lower_t(L, B, *, inv=None):
    """L^-T B for L [M, M] (upper triangle ignored) and B [M, Nb]; ``inv``
    as for trsm_lower."""
    if B is None:
        raise ValueError("trsm_lower_t: B must be [M, Nb], got None")
    if not _check_shapes("trsm_lower_t", L, B):
        return trsm_lower_t_plain(L, B)
    X = _launch("trsm_lower_t", L, B, inv)
    trsm_lower_t.launches += 1
    return X


trsm_lower.launches = 0
trsm_lower_t.launches = 0
