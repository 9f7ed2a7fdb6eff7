"""The tril KL of modulatedgps_tpu_torch (ops/kl.py, ops/kl_kernel.py)
against the JAX package.

gauss_kl reads a rank-3 q_sqrt through tril unless assume_tril says it is
lower-triangular already, as JAX's does: on a q_sqrt that is not, the two
agree in f64 at 1e-12, where reading it as given (the port's old form) is
off by more than 1.  The plain versions of kernels #12 (kl_sq_logdiag) and
#13 (kl_bwd_scale) are held against the Pallas kernels run in interpret
mode at K=3, M=1024 (several tril blocks), f32: the sums at rtol 1e-5 (the
JAX suite's tolerance, tests/test_conditionals_kl.py; both sum 1.6e6 f32
squares in other orders), the backward at rtol 1e-5 on the lower triangle
and exactly 0 above it.  The routed f32 KL (assume_tril=True) matches JAX's
routed KL at rtol 1e-5 in value and gradients; f64 and assume_tril=False
keep the dense form.
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import kl as jkl
from modulatedgps_tpu.ops import pallas_kl

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.ops import kl, kl_kernel

K, M = 3, 1024


def _mats():
    """JAX's TestPallasKL inputs: tril 0.05 N(0, 1), |diag| + 0.5, f32."""
    rng = np.random.default_rng(5)
    Lq = np.tril(rng.normal(size=(K, M, M)) * 0.05).astype(np.float32)
    for k in range(K):
        np.fill_diagonal(Lq[k], np.abs(Lq[k].diagonal()) + 0.5)
    q_mu = rng.normal(size=(M, K)).astype(np.float32)
    return q_mu, Lq


def test_gauss_kl_reads_rank3_q_sqrt_through_tril():
    rng = np.random.default_rng(0)
    q_mu, q_sqrt = rng.normal(size=(6, 2)), rng.normal(size=(2, 6, 6))
    want, jgrad = jax.value_and_grad(jkl.gauss_kl, argnums=(0, 1))(
        jnp.asarray(q_mu), jnp.asarray(q_sqrt))
    np.testing.assert_allclose(
        float(jkl.gauss_kl(jnp.asarray(q_mu), jnp.asarray(np.tril(q_sqrt)))),
        float(want), rtol=1e-12)
    tm = torch.tensor(q_mu, requires_grad=True)
    ts = torch.tensor(q_sqrt, requires_grad=True)
    got = kl.gauss_kl(tm, ts)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-12)
    for g, ref in ((tm.grad, jgrad[0]), (ts.grad, jgrad[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-14)
    as_given = float(kl.gauss_kl(tm, ts, assume_tril=True).detach())
    assert abs(as_given - float(want)) > 1.0


@pytest.mark.parametrize("which", ["sumsq", "logdiag"])
def test_kl_sq_logdiag_plain_matches_pallas_interpret(which):
    _, Lq = _mats()
    want = pallas_kl.kl_sq_logdiag(jnp.asarray(Lq), interpret=True)
    got = kl_kernel.kl_sq_logdiag_plain(torch.as_tensor(Lq))
    i = ["sumsq", "logdiag"].index(which)
    assert got[i].dtype == torch.float32 and got[i].ndim == 0
    np.testing.assert_allclose(float(got[i]), float(want[i]), rtol=1e-5)
    ref = (np.square(Lq.astype(np.float64)).sum() if i == 0 else
           np.log(np.abs(np.diagonal(Lq, axis1=-2, axis2=-1)
                         .astype(np.float64))).sum())
    np.testing.assert_allclose(float(got[i]), ref, rtol=1e-5)


def test_kl_sq_logdiag_plain_reads_only_the_lower_triangle():
    _, Lq = _mats()
    t = torch.as_tensor(Lq[:, :64, :64].copy())
    garbage = t + torch.triu(torch.full((64, 64), float("nan")), 1)
    for a, b in zip(kl_kernel.kl_sq_logdiag_plain(t),
                    kl_kernel.kl_sq_logdiag_plain(garbage)):
        assert torch.equal(a, b)


def test_kl_bwd_scale_plain_matches_pallas_interpret():
    _, Lq = _mats()
    d_j = np.asarray(pallas_kl.kl_bwd_scale(jnp.asarray(Lq),
                                            jnp.asarray(0.7, jnp.float32),
                                            interpret=True))
    got = kl_kernel.kl_bwd_scale_plain(torch.as_tensor(Lq),
                                       torch.tensor(0.7)).numpy()
    il = np.tril_indices(M)
    np.testing.assert_allclose(got[:, il[0], il[1]], d_j[:, il[0], il[1]],
                               rtol=1e-5, atol=1e-7)
    assert not np.triu(got, 1).any()


def _routed_grad(q_mu, Lq, dtype, assume_tril=True):
    tm = torch.tensor(q_mu, dtype=dtype, requires_grad=True)
    ts = torch.tensor(Lq, dtype=dtype, requires_grad=True)
    value = kl.gauss_kl(tm, ts, assume_tril=assume_tril)
    value.backward()
    return value.detach(), tm.grad, ts.grad


def test_routed_f32_kl_matches_jax_routed_kl():
    """assume_tril=True in f32 takes #12 forward and #13 backward (their
    plain versions here); JAX forced onto its Pallas route, interpreted."""
    q_mu, Lq = _mats()
    calls = []

    def spy(fn):
        def wrapped(*a):
            calls.append(fn.__name__)
            return fn(*a)
        return wrapped

    with mock.patch.object(kl, "kl_sq_logdiag", spy(kl.kl_sq_logdiag)), \
            mock.patch.object(kl, "kl_bwd_scale", spy(kl.kl_bwd_scale)):
        value, g_mu, g_sq = _routed_grad(q_mu, Lq, torch.float32)
    assert calls == ["kl_sq_logdiag", "kl_bwd_scale"]
    try:
        jkl.set_kl_tril_dispatch(True)
        want, jgrad = jax.value_and_grad(
            lambda m, s: jkl.gauss_kl(m, s, assume_tril=True), argnums=(0, 1))(
                jnp.asarray(q_mu), jnp.asarray(Lq))
    finally:
        jkl.set_kl_tril_dispatch(None)
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(g_mu.numpy(), np.asarray(jgrad[0]), rtol=1e-5)
    il = np.tril_indices(M)
    np.testing.assert_allclose(g_sq.numpy()[:, il[0], il[1]],
                               np.asarray(jgrad[1])[:, il[0], il[1]],
                               rtol=1e-5, atol=1e-7)
    assert not torch.triu(g_sq, 1).any()


@pytest.mark.parametrize("dtype,assume_tril", [(torch.float64, True),
                                               (torch.float32, False)])
def test_f64_and_assume_tril_false_keep_the_dense_form(dtype, assume_tril):
    q_mu, Lq = _mats()
    q_mu, Lq = q_mu[:40, :2], Lq[:2, :40, :40]

    def refuse(*a):
        raise AssertionError("routed to the tril kernels")

    with mock.patch.object(kl, "kl_sq_logdiag", refuse), \
            mock.patch.object(kl, "kl_bwd_scale", refuse):
        value, _, g_sq = _routed_grad(q_mu, Lq, dtype, assume_tril)
    want = jkl.gauss_kl(jnp.asarray(q_mu, jnp.float64),
                        jnp.asarray(Lq, jnp.float64))
    np.testing.assert_allclose(float(value), float(want),
                               rtol=1e-12 if dtype == torch.float64 else 1e-5)
    assert not torch.triu(g_sq, 1).any()


def test_svgp_prior_kl_routes_its_tril_q_sqrt():
    """SVGP.prior_kl passes assume_tril for a "tril" q_sqrt, so an f32
    layer's KL takes kernel #12's route."""
    rng = np.random.default_rng(2)
    layer = pt.SVGP.create(pt.SquaredExponential.create(device="cpu"),
                           rng.normal(size=(16, 2)), 2, device="cpu")
    with torch.no_grad():
        layer.q_sqrt.raw.add_(0.1 * torch.tril(torch.randn(2, 16, 16)))
    with mock.patch.object(kl, "kl_sq_logdiag",
                           wraps=kl.kl_sq_logdiag) as spy:
        value = layer.prior_kl()
    assert spy.call_count == 1
    want = jkl.gauss_kl(jnp.asarray(layer.q_mu.value.detach().numpy()),
                        jnp.asarray(layer.q_sqrt.value.detach().numpy()))
    np.testing.assert_allclose(float(value.detach()), float(want), rtol=1e-5)
