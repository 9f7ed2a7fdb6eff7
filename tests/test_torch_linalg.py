"""Triangular solves and the conditional of modulatedgps_tpu_torch against
the JAX package.

trsm_lower on CPU tensors runs its plain version; it is held against the
JAX Pallas TRSM in interpret mode at f32: the VMEM-resident blocked solve at
M=384 and the 512-row panel solve at M=1536 (3 panels), both with B = I as
on the serving path.  L is the Cholesky factor of a jittered SE Gram matrix.
Tolerance: each result is compared through its residual against the f64
solve, scaled by max|X|: rtol 2e-3 / atol 2e-3 of scale, the bound the
repo's own Pallas TRSM tests use for f32 against scipy.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import conditionals as jc
from modulatedgps_tpu.ops import pallas_linalg as PL

from modulatedgps_tpu_torch.ops import conditionals as tc
from modulatedgps_tpu_torch.ops import linalg as tl
from modulatedgps_tpu_torch.ops.trsm_kernel import trsm_lower


def _chol_factor(M, seed=0):
    rng = np.random.default_rng(seed)
    Z = rng.uniform(-3, 3, size=(M, 4))
    d2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    Kmm = np.exp(-0.5 * d2 / 0.5 ** 2) + 1e-2 * np.eye(M)
    return np.linalg.cholesky(Kmm)


@pytest.mark.parametrize("M,jax_solve", [
    (384, PL.solve_triangular_blocked),
    (1536, PL.solve_triangular_large),
])
def test_trsm_inverse_matches_pallas_interpret(M, jax_solve):
    L64 = _chol_factor(M)
    L = L64.astype(np.float32)
    want = np.asarray(jax_solve(jnp.asarray(L), jnp.eye(M, dtype=jnp.float32),
                                True, False, True))
    got = trsm_lower(torch.as_tensor(L)).numpy()
    truth = np.linalg.inv(L.astype(np.float64))
    scale = np.abs(truth).max()
    assert got.dtype == np.float32 and got.shape == (M, M)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * scale)
    np.testing.assert_allclose(got, truth, rtol=2e-3, atol=2e-3 * scale)


def test_trsm_general_rhs_and_upper_garbage():
    """B != I, and the upper triangle of L is never read."""
    rng = np.random.default_rng(3)
    L = _chol_factor(130, seed=3)
    B = rng.normal(size=(130, 70))
    noisy = L + np.triu(rng.normal(size=L.shape), 1)
    got = trsm_lower(torch.as_tensor(noisy), torch.as_tensor(B)).numpy()
    np.testing.assert_allclose(L @ got, B, rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(tl.solve_lower(torch.as_tensor(L),
                                              torch.as_tensor(B)).numpy(),
                               got, rtol=1e-12, atol=1e-12)


def test_whiten_solve_matches_jax_f64():
    rng = np.random.default_rng(4)
    L = _chol_factor(50, seed=4)
    Kmm = L @ L.T
    Kmn = rng.normal(size=(50, 30))
    want = np.asarray(jnp.linalg.solve(jnp.asarray(L), jnp.asarray(Kmn)))
    got = tl.whiten_solve(torch.as_tensor(Kmm), torch.as_tensor(Kmn)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-9)
    jit = tl.add_jitter(torch.as_tensor(Kmm), 0.5).numpy()
    np.testing.assert_allclose(jit, Kmm + 0.5 * np.eye(50), rtol=0, atol=0)


@pytest.mark.parametrize("q_sqrt_kind", ["tril", "diag", "none"])
def test_base_conditional_matches_jax_f64(q_sqrt_kind):
    """The whitened diag conditional for each q_sqrt form, f64; rtol 1e-9
    (same algorithm, summation order aside)."""
    rng = np.random.default_rng(5)
    M, N, K = 40, 25, 3
    L = _chol_factor(M, seed=5)
    Kmm = L @ L.T
    Kmn = 0.3 * rng.normal(size=(M, N))
    Knn = 1.0 + rng.uniform(size=N)
    q_mu = rng.normal(size=(M, K))
    q_sqrt = {"tril": rng.normal(size=(K, M, M)),
              "diag": rng.uniform(0.1, 1.0, size=(M, K)),
              "none": None}[q_sqrt_kind]
    mj, vj = jc.base_conditional(
        jnp.asarray(Kmn), jnp.asarray(Kmm), jnp.asarray(Knn),
        jnp.asarray(q_mu),
        q_sqrt=None if q_sqrt is None else jnp.asarray(q_sqrt))
    t = lambda a: None if a is None else torch.as_tensor(a)
    mt, vt = tc.base_conditional(t(Kmn), t(Kmm), t(Knn), t(q_mu),
                                 q_sqrt=t(q_sqrt))
    for got, want in ((mt, mj), (vt, vj)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max())


def test_base_conditional_refuses_unported_forms():
    """The forms once refused now run: the unwhitened conditional (with Kmm
    = I it is the whitened one), and the gradient of the f32 joint
    covariance (the backward of the f32 tril forward, #6/#7)."""
    rng = np.random.default_rng(7)
    Kmn = torch.as_tensor(rng.normal(size=(2, 3)))
    q_mu = torch.as_tensor(rng.normal(size=(2, 2)))
    eye = torch.eye(2, dtype=torch.float64)
    Knn = torch.full((3,), 2.0, dtype=torch.float64)
    for a, b in zip(tc.base_conditional(Kmn, eye, Knn, q_mu, white=False),
                    tc.base_conditional(Kmn, eye, Knn, q_mu)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)
    q_sqrt = torch.eye(2).expand(2, 2, 2).clone().requires_grad_()
    _, cov = tc.base_conditional(Kmn.float(), torch.eye(2), torch.eye(3),
                                 torch.zeros(2, 2), q_sqrt=q_sqrt, full_cov=True)
    cov.sum().backward()
    assert torch.isfinite(q_sqrt.grad).all() and q_sqrt.grad.abs().sum() > 0
    assert not torch.triu(q_sqrt.grad, 1).any()


@pytest.mark.parametrize("full_cov", [False, True])
def test_expand_independent_outputs_matches_jax(full_cov):
    rng = np.random.default_rng(6)
    fvar = rng.uniform(size=(3, 5, 5) if full_cov else (5, 3))
    want = np.asarray(jc.expand_independent_outputs(jnp.asarray(fvar),
                                                    full_cov, True))
    got = tc.expand_independent_outputs(torch.as_tensor(fvar), full_cov, True)
    np.testing.assert_array_equal(got.numpy(), want)
