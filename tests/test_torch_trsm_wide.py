"""The TRSM on wide and lower-triangular right sides (modulatedgps_tpu_torch
ops/trsm_kernel.py, csrc/trsm.cu), on the CPU.

- gauss_kl with the prior covariance Kmm against JAX in f64 (rtol 1e-9,
  atol 1e-9 of each gradient's largest entry) at M not a multiple of the
  kernels' 64-row blocks and strips: its forward solves take
  ``tril_rhs=True``, which the plain version ignores.
- The blocked walk that skips a strip's zero block rows, emulated in torch
  with the kernels' strip widths (8 and 64) and block order, gives exactly
  the unskipped walk's result on a lower-triangular right side, a strip
  holding columns of two latents included.
- The wrapper refuses ``tril_rhs`` without a width that is a multiple of M,
  and passes (work, unit_rhs, tril_rhs, inv_given) to the entry point.
- Every ctypes argument list in _native.py matches its ``extern "C"``
  signature, parsed from csrc/*.cu.
"""
import re
import unittest.mock as mock
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import kl as jkl

from modulatedgps_tpu_torch import _native
from modulatedgps_tpu_torch.ops import kl as tkl
from modulatedgps_tpu_torch.ops import linalg as tl
from modulatedgps_tpu_torch.ops import trsm_kernel

RTOL = 1e-9
BS = trsm_kernel.BLOCK


def _spd(M, rng):
    Z = rng.normal(size=(M, 2))
    d = ((Z[:, None] - Z[None]) ** 2).sum(-1)
    return np.exp(-0.5 * d / 0.8) + 1e-3 * np.eye(M)


def _close(got, want, rtol=RTOL):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("M, K", [(70, 2), (130, 3)])
@pytest.mark.parametrize("form", ["tril", "tril_assumed", "diag"])
def test_gauss_kl_with_prior_at_ragged_m_matches_jax_f64(M, K, form):
    """Value and gradients (q_mu, q_sqrt, Kmm) of the unwhitened KL, whose
    solves pass tril_rhs, against JAX at f64."""
    rng = np.random.default_rng(M + K)
    Kmm = _spd(M, rng)
    q_mu = rng.normal(size=(M, K))
    if form == "diag":
        q_sqrt = rng.uniform(0.2, 1.0, size=(M, K))
    else:
        q_sqrt = 0.3 * np.tril(rng.normal(size=(K, M, M)), -1) + np.diag(
            rng.uniform(0.5, 1.5, size=M))
        if form == "tril":   # upper garbage that gauss_kl must tril away
            q_sqrt = q_sqrt + np.triu(rng.normal(size=(K, M, M)), 1)
    assume = form == "tril_assumed"
    val, grads = jax.value_and_grad(
        lambda a, b, c: jkl.gauss_kl(a, b, c, assume_tril=assume),
        argnums=(0, 1, 2))(*map(jnp.asarray, (q_mu, q_sqrt, Kmm)))
    ts = [torch.tensor(a, requires_grad=True) for a in (q_mu, q_sqrt, Kmm)]
    kl = tkl.gauss_kl(*ts, assume_tril=assume)
    kl.backward()
    np.testing.assert_allclose(float(kl.detach()), float(val), rtol=RTOL)
    for t, g, sym in zip(ts, grads, (False, False, True)):
        want = np.asarray(g)
        _close(t.grad.numpy(), 0.5 * (want + want.T) if sym else want)


def test_gauss_kl_passes_tril_rhs_to_its_forward_solves():
    """The KL's q_sqrt and identity right sides are lower-triangular and
    are solved with tril_rhs; q_mu's solve and every pullback solve are
    not."""
    rng = np.random.default_rng(3)
    M, K = 70, 2
    Kmm = torch.tensor(_spd(M, rng), requires_grad=True)
    q_mu = torch.tensor(rng.normal(size=(M, K)), requires_grad=True)
    tril = torch.tensor(np.tril(rng.normal(size=(K, M, M))) + 2 * np.eye(M))
    diag = torch.tensor(rng.uniform(0.5, 1.0, size=(M, K)))
    calls = []

    def recording(fn, name):
        def solve(L, B=None, *, inv=None, **kw):
            calls.append((name, None if B is None else B.shape[1],
                          kw.get("tril_rhs", False)))
            return fn(L, B, inv=inv, **kw)
        return solve

    with mock.patch.object(tl, "trsm_lower",
                           recording(trsm_kernel.trsm_lower, "fwd")), \
            mock.patch.object(tl, "trsm_lower_t",
                              recording(trsm_kernel.trsm_lower_t, "trans")):
        for q_sqrt in (tril, diag):
            calls.clear()
            tkl.gauss_kl(q_mu, q_sqrt.requires_grad_(), Kmm).backward()
            forward = [c for c in calls if c[0] == "fwd" and c[1] != M]
            wide = [c for c in calls if c[1] == (K * M if q_sqrt.ndim == 3
                                                 else M)]
            assert ("fwd", K, False) in forward
            assert [c for c in wide if c[0] == "fwd" and c[2]], calls
            assert all(not c[2] for c in calls if c[0] == "trans")
            assert all(not c[2] for c in calls if c[1] == K)


def _first_block(c0, w, M, Nb):
    """csrc/trsm.cu's first_block."""
    lc = c0 % M
    return lc // BS if (lc + w <= M or c0 - lc + M >= Nb) else 0


def _walk(L, B, w, skip):
    """csrc/trsm.cu's forward walk in torch ops, strip by strip of w
    columns: acc = B_k - sum_{j} L_kj X_j in ascending j, then X_k =
    Inv_kk acc; with ``skip`` a strip starts at _first_block (rows above
    written as zeros)."""
    M, Nb = B.shape
    nblk = -(-M // BS)
    Lp = torch.eye(nblk * BS, dtype=L.dtype)
    Lp[:M, :M] = torch.tril(torch.nan_to_num(L, nan=0.0))
    Bp = torch.zeros(nblk * BS, Nb, dtype=B.dtype)
    Bp[:M] = B
    inv = [torch.linalg.inv(Lp[k * BS:(k + 1) * BS, k * BS:(k + 1) * BS])
           for k in range(nblk)]
    X = torch.zeros_like(Bp)
    for c0 in range(0, Nb, w):
        cs = slice(c0, min(c0 + w, Nb))
        k0 = _first_block(c0, w, M, Nb) if skip else 0
        for k in range(k0, nblk):
            rows = slice(k * BS, (k + 1) * BS)
            acc = Bp[rows, cs].clone()
            for j in range(k0, k):
                acc = acc - Lp[rows, j * BS:(j + 1) * BS] @ X[j * BS:(j + 1) * BS, cs]
            X[rows, cs] = inv[k] @ acc
    return X[:M]


@pytest.mark.parametrize("w", [8, 64])
@pytest.mark.parametrize("M, K", [(128, 2), (130, 3), (200, 2), (64, 3)])
def test_skipping_zero_block_rows_gives_the_unskipped_result(w, M, K):
    """On a right side lower-triangular in each latent's M columns (NaN
    above L's diagonal), the skipping walk equals the full walk exactly
    and solves the system."""
    rng = np.random.default_rng(M * 10 + K)
    L = torch.tensor(np.linalg.cholesky(_spd(M, rng)), dtype=torch.float32)
    L_nan = L + torch.triu(torch.full((M, M), float("nan")), 1)
    Lq = torch.tril(torch.tensor(rng.normal(size=(K, M, M)),
                                 dtype=torch.float32))
    B = Lq.permute(1, 0, 2).reshape(M, K * M)
    skipped, full = _walk(L_nan, B, w, True), _walk(L_nan, B, w, False)
    assert torch.equal(skipped, full)
    want = torch.linalg.solve_triangular(L.double(), B.double(), upper=False)
    np.testing.assert_allclose(skipped.double().numpy(), want.numpy(),
                               rtol=1e-3, atol=1e-3 * float(want.abs().max()))


def test_first_block_matches_unit_rhs_on_the_identity():
    """With B = I (Nb = M) every strip starts at its own first column's
    block row, as the inverse's unit_rhs walk (64-column strips) does."""
    for M in (1, 64, 130, 4096):
        for c0 in range(0, M, 64):
            assert _first_block(c0, 64, M, M) == c0 // BS
            assert trsm_kernel.first_block(c0, 64, M, M) == c0 // BS


@pytest.mark.parametrize("B_shape", [None, (6, 7), (6, 13)])
def test_trsm_lower_refuses_tril_rhs_without_a_multiple_of_m(B_shape):
    L = torch.eye(6)
    B = None if B_shape is None else torch.ones(B_shape)
    with pytest.raises(ValueError, match="tril_rhs"):
        trsm_kernel.trsm_lower(L, B, tril_rhs=True)


def test_solve_lower_refuses_tril_rhs_on_the_transposed_solve():
    with pytest.raises(ValueError, match="tril_rhs"):
        tl.solve_lower(torch.eye(4), torch.ones(4, 8), trans=True,
                       tril_rhs=True)


@pytest.mark.parametrize("Nb", [12, 18])
def test_tril_rhs_plain_result_is_the_plain_solve(Nb):
    """The plain version ignores tril_rhs: the same bits either way."""
    rng = np.random.default_rng(Nb)
    L = torch.tensor(np.linalg.cholesky(_spd(6, rng)))
    B = torch.tensor(rng.normal(size=(6, Nb)))
    assert torch.equal(trsm_kernel.trsm_lower(L, B, tril_rhs=True),
                       trsm_kernel.trsm_lower(L, B))


class _OnTheCard:
    """Stands in for a CUDA tensor for the launcher's checks: its device
    reads as the card, its data is a CPU tensor's."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape, self.ndim = t.dtype, t.shape, t.ndim
        self.requires_grad = False

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.mark.parametrize("case", ["inverse", "wide", "tril_rhs", "inv_given",
                                  "transposed"])
def test_trsm_launcher_passes_its_flags(case):
    """The entry point gets (L, inv, B, X, work, M, Nb, unit_rhs, tril_rhs,
    inv_given, stream) for L^-1 B and (L, inv, B, X, work, M, Nb,
    inv_given, stream) for L^-T B, with the launch counted."""
    M, Nb = 8, 24
    calls = []

    class Lib:
        def mgp_trsm_lower(self, *args):
            calls.append(args)
            return 0

        def mgp_trsm_lower_t(self, *args):
            calls.append(args)
            return 0

    L = _OnTheCard(torch.eye(M))
    B = None if case == "inverse" else _OnTheCard(torch.ones(M, Nb))
    inv = _OnTheCard(torch.ones(1, BS, BS)) if case == "inv_given" else None
    real_empty, real_zeros, scratch = torch.empty, torch.zeros, []
    cpu_empty = lambda *a, device=None, **kw: real_empty(*a, **kw)  # noqa: E731

    def cpu_zeros(*a, device=None, **kw):
        scratch.append(real_zeros(*a, **kw))
        return scratch[-1]

    fn = trsm_kernel.trsm_lower_t if case == "transposed" else trsm_kernel.trsm_lower
    kw = {"tril_rhs": True} if case == "tril_rhs" else {}
    before = fn.launches
    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 77), \
            mock.patch.object(trsm_kernel.torch, "empty", cpu_empty), \
            mock.patch.object(trsm_kernel.torch, "zeros", cpu_zeros):
        X = fn(L, B, inv=inv, **kw)
    (args,) = calls
    width = M if B is None else Nb
    assert X.shape == (M, width) and args[3] == X.data_ptr()
    (work,) = scratch
    assert args[4] == work.data_ptr() and work.dtype == torch.int32
    assert args[2] == (None if B is None else B.data_ptr())
    if inv is not None:
        assert args[1] == inv.data_ptr()
    if case == "transposed":
        assert args[5:] == (M, width, 0, 77)
    else:
        assert args[5:] == (M, width, int(case == "inverse"),
                            int(case == "tril_rhs"), int(case == "inv_given"),
                            77)
    assert fn.launches == before + 1
    fn.launches = before


_CSRC = Path(_native.__file__).resolve().parent / "csrc"
_CTYPE = {"void*": _native._P, "constvoid*": _native._P, "int": _native._I,
          "float": _native._F}


def _c_signatures():
    """name -> argument type list of every extern "C" entry in csrc/*.cu."""
    sigs = {}
    for path in sorted(_CSRC.glob("*.cu")):
        text = path.read_text()
        for name, params in re.findall(
                r'extern "C" int (\w+)\(([^)]*)\)', text):
            kinds = []
            for p in params.split(","):
                p = " ".join(p.split())
                decl = re.sub(r"\s*\b\w+$", "", p)      # drop the name
                kinds.append(_CTYPE[decl.replace(" ", "")])
            sigs[name] = kinds
    return sigs


@pytest.mark.parametrize("name", sorted(_native._SIGNATURES))
def test_loader_signature_matches_the_c_entry_point(name):
    """Each ctypes argument list has the entry point's arity and types, as
    csrc/*.cu declares them (a missing int would shift the stream)."""
    sigs = _c_signatures()
    assert name in sigs, f"{name} not declared in csrc/*.cu"
    assert list(_native._SIGNATURES[name]) == sigs[name]
