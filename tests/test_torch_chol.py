"""The blocked Cholesky of modulatedgps_tpu_torch (ops/chol_kernel.py, kernels
#15/#16) and its place under ops.linalg, against the JAX package.

cholesky_factor_plain, run with the JAX kernels' 128-blocks, is held
against the Pallas Cholesky in interpret mode: cholesky_blocked (#15,
_chol_kernel) at M = 128, 200 (an identity-padded tail) and 384, and
_chol_pallas_large (#16, _chol_kernel_large) at M = 512, comparing L and
the diagonal-block inverses Inv in f32.  Inputs are the JAX suite's SPD
matrices (A A^T / M + I, condition number < 10), on which any two f32
factorizations agree to a few ulps: rtol 2e-5 and atol 2e-5 of the
largest magnitude, for L and for Inv (JAX inverts by Newton steps, the
port by substitution).  In f64, ops.linalg.cholesky (the plain blocked
factor with 64-blocks on the CPU) matches jnp.linalg.cholesky at 1e-12 of
the largest entry and its Murray pullback matches JAX's gradient at 1e-9,
at M = 150 (three blocks, a ragged tail).
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import conditionals as jc
from modulatedgps_tpu.ops import pallas_linalg as PL

from modulatedgps_tpu_torch import _native
from modulatedgps_tpu_torch.ops import chol_kernel, linalg, trsm_kernel
from modulatedgps_tpu_torch.ops import conditionals as tc


def _spd(M, seed=0, dtype=np.float32):
    A = np.random.default_rng(seed).normal(size=(M, M))
    return (A @ A.T / M + np.eye(M)).astype(dtype)


def _close(got, want, tol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=tol,
                               atol=tol * np.abs(want).max())


@pytest.mark.parametrize("M", [128, 200, 384])
def test_plain_factor_matches_pallas_chol_kernel(M):
    A = _spd(M)
    Mp = (M + PL.BLK - 1) // PL.BLK * PL.BLK
    L_j, Inv_j = PL._chol_pallas_raw(PL._pad_spd(jnp.asarray(A), Mp),
                                     interpret=True)
    L, Inv = chol_kernel.cholesky_factor_plain(torch.as_tensor(A), block=128)
    assert L.dtype == Inv.dtype == torch.float32
    assert Inv.shape == (Mp // 128, 128, 128)
    _close(L.numpy(), np.asarray(L_j)[:M, :M], 2e-5)
    _close(Inv.numpy(), Inv_j, 2e-5)
    assert not torch.triu(L, 1).any()


def test_plain_factor_matches_pallas_chol_kernel_large():
    M = 512
    A = _spd(M, seed=1)
    L_j, Inv_j = PL._chol_pallas_large(jnp.asarray(A), interpret=True)
    L, Inv = chol_kernel.cholesky_factor_plain(torch.as_tensor(A), block=128)
    _close(L.numpy(), L_j, 2e-5)
    _close(Inv.numpy(), Inv_j, 2e-5)


def test_port_cholesky_matches_jax_f64_value_and_gradient():
    M = 150
    K = _spd(M, seed=2, dtype=np.float64)
    W = np.random.default_rng(3).normal(size=(M, M))
    loss_j = lambda K: jnp.sum(jnp.sin(jnp.linalg.cholesky(K)) * W)
    L_j = np.asarray(jnp.linalg.cholesky(jnp.asarray(K)))
    g_j = np.asarray(jax.grad(loss_j)(jnp.asarray(K)))
    Kt = torch.as_tensor(K).requires_grad_()
    L = linalg.cholesky(Kt)
    (torch.sin(L) * torch.as_tensor(W)).sum().backward()
    np.testing.assert_allclose(L.detach().numpy(), L_j, rtol=0,
                               atol=1e-12 * np.abs(L_j).max())
    # JAX's gradient of a symmetric input; the port's pullback is symmetric
    g_j = 0.5 * (g_j + g_j.T)
    np.testing.assert_allclose(Kt.grad.numpy(), g_j, rtol=1e-9,
                               atol=1e-9 * np.abs(g_j).max())


def test_conditional_over_several_blocks_matches_jax_f64():
    """The whitened conditional at M=150 (the multi-block plain factor and
    the inverse fed its diagonal-block inverses): rtol 1e-9."""
    rng = np.random.default_rng(4)
    M, N, K = 150, 40, 2
    Kmm = _spd(M, seed=4, dtype=np.float64)
    Kmn = 0.3 * rng.normal(size=(M, N))
    Knn = 2.0 + rng.uniform(size=N)
    q_mu = rng.normal(size=(M, K))
    q_sqrt = np.tril(0.1 * rng.normal(size=(K, M, M))) + np.eye(M)
    want = jc.base_conditional(*map(jnp.asarray, (Kmn, Kmm, Knn, q_mu)),
                               q_sqrt=jnp.asarray(q_sqrt))
    got = tc.base_conditional(*map(torch.as_tensor, (Kmn, Kmm, Knn, q_mu)),
                              q_sqrt=torch.as_tensor(q_sqrt))
    for g, w in zip(got, want):
        _close(g.numpy(), w, 1e-9)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_not_positive_definite_gives_nan_without_raising(dtype):
    """A pivot of -1 at column c0: NaN from there on, the columns before
    it finite, as jnp.linalg.cholesky gives NaN rather than raising."""
    M, c0 = 150, 100
    K = _spd(M, seed=5, dtype=np.float64)
    K[c0, c0] = -1.0
    assert np.isnan(np.asarray(jnp.linalg.cholesky(jnp.asarray(K)))).any()
    L = linalg.cholesky(torch.as_tensor(K, dtype=dtype))
    assert torch.isnan(L[c0, c0])
    assert torch.isfinite(L[:, :c0]).all()
    L_f, Inv_f = chol_kernel.cholesky_factor(torch.as_tensor(K, dtype=dtype))
    assert torch.isnan(L_f[c0:, c0:].diagonal()).all()
    assert torch.isfinite(Inv_f[0]).all() and torch.isnan(Inv_f[1]).any()


def test_trsm_fed_the_factor_inverses_matches_recomputing_them():
    K = torch.as_tensor(_spd(150, seed=6))
    L, Inv = linalg.cholesky_with_inv(K)
    B = torch.randn(150, 33)
    assert Inv.shape == (3, 64, 64)
    assert torch.equal(trsm_kernel.trsm_lower(L, B, inv=Inv),
                       trsm_kernel.trsm_lower(L, B))
    assert torch.equal(trsm_kernel.trsm_lower(L, inv=Inv),
                       trsm_kernel.trsm_lower(L))
    assert torch.equal(trsm_kernel.trsm_lower_t(L, B, inv=Inv),
                       trsm_kernel.trsm_lower_t(L, B))
    assert torch.equal(linalg.triangular_inverse(L, Inv),
                       linalg.triangular_inverse(L))


def test_unwhitened_solves_are_fed_the_factor_inverses():
    """The unwhitened conditional and KL hand the Cholesky's diagonal-block
    inverses to every solve, forward and backward, so no solve on that path
    recomputes them."""
    rng = np.random.default_rng(7)
    M, N, K = 150, 40, 2
    Kmm = torch.as_tensor(_spd(M, seed=7, dtype=np.float64)).requires_grad_()
    Kmn = torch.as_tensor(0.3 * rng.normal(size=(M, N))).requires_grad_()
    Knn = torch.as_tensor(2.0 + rng.uniform(size=N))
    q_mu = torch.as_tensor(rng.normal(size=(M, K))).requires_grad_()
    q_sqrt = torch.as_tensor(np.tril(0.1 * rng.normal(size=(K, M, M)))
                             + np.eye(M)).requires_grad_()
    seen = []

    def recording(fn):
        def solve(L, B=None, *, inv=None, **kw):
            seen.append(None if inv is None else tuple(inv.shape))
            return fn(L, B, inv=inv, **kw)
        return solve

    from modulatedgps_tpu_torch.ops import kl
    with mock.patch.object(linalg, "trsm_lower",
                           recording(trsm_kernel.trsm_lower)), \
            mock.patch.object(linalg, "trsm_lower_t",
                              recording(trsm_kernel.trsm_lower_t)):
        mean, var = tc.base_conditional(Kmn, Kmm, Knn, q_mu, q_sqrt=q_sqrt,
                                        white=False)
        loss = (mean.sum() + var.sum()
                + kl.gauss_kl(q_mu, q_sqrt, Kmm, assume_tril=True))
        loss.backward()
    # conditional: 2 solves + 2 pullback solves; KL: 2 + 2; the two
    # Cholesky pullbacks' inverses
    assert len(seen) == 10
    assert all(s == (3, 64, 64) for s in seen)
    assert all(torch.isfinite(t.grad).all() for t in (Kmm, Kmn, q_mu, q_sqrt))


class _OnTheCard:
    """Stands in for a CUDA tensor: the launcher's checks read its device,
    dtype, shape, layout and grad flag, then hand its pointer on."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape, self.ndim = t.dtype, t.shape, t.ndim
        self.requires_grad = False

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return 4096


def test_launcher_reaches_the_kernel_entry_or_raises():
    calls = []

    class Lib:
        def mgp_cholesky(self, *args):
            calls.append(args)
            return 0

    real_empty = torch.empty
    made = []

    def cpu_empty(*a, device=None, **kw):
        made.append(real_empty(*a, **kw))
        return made[-1]

    before = chol_kernel.cholesky_factor.launches
    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 77), \
            mock.patch.object(chol_kernel.torch, "empty", cpu_empty):
        L, Inv = chol_kernel.cholesky_factor(_OnTheCard(torch.eye(70)))
        assert L.shape == (70, 70) and Inv.shape == (2, 64, 64)
        work = made[-1]          # the task and tile counters: 1 + 2 x 2
        assert work.shape == (5,) and work.dtype == torch.int32
        assert calls == [(4096, L.data_ptr(), Inv.data_ptr(), work.data_ptr(),
                          None, 70, 77)]
        assert chol_kernel.cholesky_factor.launches == before + 1
        with pytest.raises(TypeError):
            chol_kernel.cholesky_factor(_OnTheCard(torch.eye(70).double()))
        with pytest.raises(ValueError, match="contiguous"):
            chol_kernel.cholesky_factor(_OnTheCard(torch.eye(70).T[::2, ::2]))
        with pytest.raises(ValueError, match=r"\[M, M\]"):
            chol_kernel.cholesky_factor(_OnTheCard(torch.zeros(3, 4)))
    assert len(calls) == 1
    chol_kernel.cholesky_factor.launches = before
