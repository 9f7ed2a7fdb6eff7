"""The port's likelihoods and Gauss-Hermite quadrature against the JAX
package, on the CPU.

The same numpy inputs go through modulatedgps_tpu's likelihoods (float64,
as the JAX suite runs them) and modulatedgps_tpu_torch's: Gaussian's new
methods, MultiClass/RobustMax (prob_is_largest, variational_expectations,
predict_mean_and_var, predict_log_density, log_prob), Bernoulli and the
quadrature, over [N, K] and [S, N, K] latents, with integer and float
labels, and the gradients with respect to Fmu and Fvar against jax.grad.

Tolerance: rtol 1e-9 in float64, atol 1e-9 of each output's largest
magnitude.  Both packages evaluate the same formulas; they differ only in
the order of a few sums.

The float32 cases hold the product over the classes' CDFs to JAX's
gradient where the product underflows (K = 12: eleven factors of the 1e-4
floor reach ~1e-44, below float32's smallest normal).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.likelihoods import Bernoulli as JBernoulli
from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.likelihoods import MultiClass as JMultiClass
from modulatedgps_tpu.likelihoods import RobustMax as JRobustMax
from modulatedgps_tpu.ops import quadrature as jquad

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.likelihoods.multiclass import prod_exclusive_grad
from modulatedgps_tpu_torch.ops import quadrature

RTOL = 1e-9
N, K, S = 9, 4, 3


def _close(got, want, what="", rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = rtol * max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol, err_msg=what)


def _t(a, dtype=torch.float64, grad=False):
    return torch.tensor(np.asarray(a), dtype=dtype, requires_grad=grad)


def _latents(rng, lead=()):
    Fmu = rng.normal(size=(*lead, N, K))
    Fvar = np.abs(rng.normal(size=(*lead, N, K))) + 0.05
    return Fmu, Fvar


LEADS = [(), (S,)]


def _labels(rng, as_float):
    Y = rng.integers(0, K, size=(N, 1))
    return Y.astype(np.float64) if as_float else Y


# -- quadrature ---------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 5, 20])
def test_gauss_hermite_points_match_jax(n):
    x, w = quadrature.gauss_hermite_points(n, torch.float64, "cpu")
    jx, jw = jquad.gauss_hermite_points(n, jnp.float64)
    np.testing.assert_array_equal(x.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))


@pytest.mark.parametrize("lead", LEADS)
def test_gauss_hermite_expectation_matches_jax(rng, lead):
    Fmu, Fvar = _latents(rng, lead)
    got = quadrature.gauss_hermite_expectation(
        lambda f: torch.sin(f) * f.square(), _t(Fmu), _t(Fvar), 20)
    want = jquad.gauss_hermite_expectation(
        lambda f: jnp.sin(f) * jnp.square(f), jnp.asarray(Fmu),
        jnp.asarray(Fvar), 20)
    _close(got, want, "E[sin(f) f^2]")
    # E[f^2] = mu^2 + var is exact at 20 points
    exact = quadrature.gauss_hermite_expectation(torch.square, _t(Fmu),
                                                 _t(Fvar))
    _close(exact, Fmu ** 2 + Fvar, "E[f^2]")


# -- Gaussian -----------------------------------------------------------------

@pytest.mark.parametrize("lead", LEADS)
def test_gaussian_new_methods_match_jax(rng, lead):
    jlik = JGaussian.create(0.5, D=K)
    jlik = jlik.replace(variance=jlik.variance.replace_raw(
        jnp.asarray(rng.normal(size=(1, K)))))
    lik = pt.Gaussian.create(0.5, D=K, dtype=torch.float64, device="cpu")
    pt.load_numpy_(lik, {"variance.raw": np.asarray(jlik.variance.raw)})
    F, _ = _latents(rng, lead)
    Y = rng.normal(size=(N, 1))
    _close(lik.log_prob(_t(F), _t(Y)),
           jlik.log_prob(jnp.asarray(F), jnp.asarray(Y)), "log_prob")
    _close(lik.conditional_mean(_t(F)), jlik.conditional_mean(jnp.asarray(F)))
    _close(lik.conditional_variance(_t(F)),
           jlik.conditional_variance(jnp.asarray(F)), "conditional_variance")
    Fmu, Fvar = _latents(rng, lead)
    args = (_t(Fmu), _t(Fvar), _t(Y))
    jargs = (jnp.asarray(Fmu), jnp.asarray(Fvar), jnp.asarray(Y))
    _close(lik.variational_expectations(*args),
           jlik.variational_expectations(*jargs), "variational_expectations")
    _close(lik.predict_log_density(*args), jlik.predict_log_density(*jargs),
           "predict_log_density")


# -- MultiClass / RobustMax -----------------------------------------------------

def _multiclass(k=K, points=20):
    return (pt.MultiClass.create(k, num_gauss_hermite_points=points),
            JMultiClass.create(k, num_gauss_hermite_points=points))


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("as_float", [False, True])
def test_prob_is_largest_matches_jax(rng, lead, as_float):
    Fmu, Fvar = _latents(rng, lead)
    Y = _labels(rng, as_float)
    inv, jinv = pt.RobustMax(num_classes=K), JRobustMax(num_classes=K)
    for points in (20, 7):
        got = inv.prob_is_largest(torch.tensor(Y), _t(Fmu), _t(Fvar), points)
        want = jinv.prob_is_largest(jnp.asarray(Y), jnp.asarray(Fmu),
                                    jnp.asarray(Fvar), points)
        _close(got, want, f"prob_is_largest, {points} points")
    # [N] labels (no trailing 1), as the JAX package reads them
    got = inv.prob_is_largest(torch.tensor(Y[:, 0]), _t(Fmu), _t(Fvar))
    _close(got, jinv.prob_is_largest(jnp.asarray(Y[:, 0]), jnp.asarray(Fmu),
                                     jnp.asarray(Fvar)), "[N] labels")
    assert inv.eps_k1 == jinv.eps_k1


@pytest.mark.parametrize("lead", LEADS)
@pytest.mark.parametrize("as_float", [False, True])
def test_multiclass_methods_match_jax(rng, lead, as_float):
    lik, jlik = _multiclass()
    Fmu, Fvar = _latents(rng, lead)
    Y = _labels(rng, as_float)
    args = (_t(Fmu), _t(Fvar), torch.tensor(Y))
    jargs = (jnp.asarray(Fmu), jnp.asarray(Fvar), jnp.asarray(Y))
    ve = lik.variational_expectations(*args)
    assert ve.shape == (*lead, N, 1)
    _close(ve, jlik.variational_expectations(*jargs),
           "variational_expectations")
    _close(lik.predict_log_density(*args), jlik.predict_log_density(*jargs),
           "predict_log_density")
    _close(lik.predict_density_per_expert(*args),
           jlik.predict_density_per_expert(*jargs), "per expert")
    mean, var = lik.predict_mean_and_var(args[0], args[1])
    jmean, jvar = jlik.predict_mean_and_var(jargs[0], jargs[1])
    _close(mean, jmean, "predict_mean_and_var mean")
    _close(var, jvar, "predict_mean_and_var var")
    _close(lik.log_prob(args[0], args[2]), jlik.log_prob(jargs[0], jargs[2]),
           "log_prob")


@pytest.mark.parametrize("lead", LEADS)
def test_multiclass_gradients_match_jax_grad(rng, lead):
    """d/d(Fmu, Fvar) of a weighted sum of the variational expectations and
    of the predictive probabilities, against jax.grad."""
    lik, jlik = _multiclass()
    Fmu, Fvar = _latents(rng, lead)
    Y = _labels(rng, False)
    wv = rng.normal(size=(*lead, N, 1))
    wm = rng.normal(size=(*lead, N, K))

    def jloss(m, v):
        ve = jlik.variational_expectations(m, v, jnp.asarray(Y))
        mean, _ = jlik.predict_mean_and_var(m, v)
        return jnp.sum(ve * wv) + jnp.sum(mean * wm)

    want = jax.grad(jloss, (0, 1))(jnp.asarray(Fmu), jnp.asarray(Fvar))
    m, v = _t(Fmu, grad=True), _t(Fvar, grad=True)
    ve = lik.variational_expectations(m, v, torch.tensor(Y))
    mean, _ = lik.predict_mean_and_var(m, v)
    ((ve * _t(wv)).sum() + (mean * _t(wm)).sum()).backward()
    _close(m.grad, want[0], "d/dFmu")
    _close(v.grad, want[1], "d/dFvar")


def test_prod_exclusive_grad_matches_jax_where_the_product_underflows():
    """float32 factors whose product flushes to 0 while each product of the
    others stays normal: the pullback is those products (jax.grad of
    jnp.prod), where torch.prod's divides 0 by the factor."""
    x = np.array([[1e-30, 1e-30, 2.0], [0.5, 0.25, 4.0]], np.float32)
    t = torch.tensor(x, requires_grad=True)
    out = prod_exclusive_grad(t, -1)
    out.sum().backward()
    np.testing.assert_array_equal(out.detach().numpy(),
                                  torch.prod(torch.tensor(x), -1).numpy())
    want = jax.grad(lambda a: jnp.sum(jnp.prod(a, axis=-1)))(jnp.asarray(x))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), rtol=1e-6)
    assert t.grad[0, 0] == pytest.approx(2e-30, rel=1e-6)
    plain = torch.tensor(x, requires_grad=True)
    torch.prod(plain, -1).sum().backward()
    assert plain.grad[0, 0] == 0.0      # what the division gives


def test_multiclass_float32_gradients_at_k12_match_jax_float32(monkeypatch):
    """K = 12 in float32, the selected class below the others: at the lower
    grid points the product of 11 CDFs falls below float32's smallest
    normal (the JAX package's CPU backend flushes such values to zero, torch
    keeps them), while the gradient is carried by the upper points.  The
    port's float32 gradients land within 1e-5 of the gradient's largest
    magnitude of JAX's float32 ones and of float64."""
    from modulatedgps_tpu_torch.likelihoods import multiclass
    k = 12
    rng = np.random.default_rng(7)
    Fmu = np.concatenate([np.zeros((N, 1)),
                          1.9 + 0.3 * rng.normal(size=(N, k - 1))], axis=1)
    Fvar = np.full((N, k), 0.3)
    Fvar[:, 0] = np.linspace(0.3, 0.8, N)
    Y = np.zeros((N, 1), np.int64)
    lik, jlik = _multiclass(k)

    def jgrads(dtype):
        f = lambda m, v: jnp.sum(jlik.variational_expectations(
            m, v, jnp.asarray(Y)))
        return [np.asarray(g, np.float64) for g in jax.grad(f, (0, 1))(
            jnp.asarray(Fmu, dtype), jnp.asarray(Fvar, dtype))]

    products = []

    def recording(x, dim):
        out = prod_exclusive_grad(x, dim)
        products.append(out.detach())
        return out

    monkeypatch.setattr(multiclass, "prod_exclusive_grad", recording)
    m = _t(Fmu, torch.float32, grad=True)
    v = _t(Fvar, torch.float32, grad=True)
    lik.variational_expectations(m, v, torch.tensor(Y)).sum().backward()
    smallest = float(products[0].min())
    assert 0 < smallest < torch.finfo(torch.float32).tiny
    want64, want32 = jgrads(jnp.float64), jgrads(jnp.float32)
    for got, w64, w32 in zip((m.grad, v.grad), want64, want32):
        got = got.double().numpy()
        scale = np.abs(w64).max()
        assert scale > 1e-6
        assert np.abs(got - w32).max() <= 1e-5 * scale
        assert np.abs(got - w64).max() <= 1e-5 * scale


# -- Bernoulli ------------------------------------------------------------------

@pytest.mark.parametrize("lead", LEADS)
def test_bernoulli_matches_jax(rng, lead):
    lik, jlik = pt.Bernoulli(), JBernoulli()
    Fmu, Fvar = _latents(rng, lead)
    Y = rng.integers(0, 2, size=(N, K)).astype(np.float64)
    args = (_t(Fmu), _t(Fvar), _t(Y))
    jargs = (jnp.asarray(Fmu), jnp.asarray(Fvar), jnp.asarray(Y))
    _close(lik.log_prob(args[0], args[2]), jlik.log_prob(jargs[0], jargs[2]),
           "log_prob")
    _close(lik.variational_expectations(*args),
           jlik.variational_expectations(*jargs), "variational_expectations")
    mean, var = lik.predict_mean_and_var(args[0], args[1])
    jmean, jvar = jlik.predict_mean_and_var(jargs[0], jargs[1])
    _close(mean, jmean, "mean")
    _close(var, jvar, "var")
    _close(lik.predict_log_density(*args), jlik.predict_log_density(*jargs),
           "predict_log_density")
    _close(lik.predict_density_per_expert(*args),
           jlik.predict_density_per_expert(*jargs), "per expert")
    _close(pt.likelihoods.bernoulli.inv_probit(args[0]),
           jax.scipy.stats.norm.cdf(jargs[0]) * (1 - 2e-3) + 1e-3, "inv_probit")


def test_bernoulli_gradients_match_jax_grad(rng):
    lik, jlik = pt.Bernoulli(), JBernoulli()
    Fmu, Fvar = _latents(rng, (S,))
    Y = rng.integers(0, 2, size=(N, K)).astype(np.float64)

    def jloss(m, v):
        return (jnp.sum(jlik.variational_expectations(m, v, jnp.asarray(Y)))
                + jnp.sum(jlik.predict_log_density(m, v, jnp.asarray(Y))))

    want = jax.grad(jloss, (0, 1))(jnp.asarray(Fmu), jnp.asarray(Fvar))
    m, v = _t(Fmu, grad=True), _t(Fvar, grad=True)
    (lik.variational_expectations(m, v, _t(Y)).sum()
     + lik.predict_log_density(m, v, _t(Y)).sum()).backward()
    _close(m.grad, want[0], "d/dFmu")
    _close(v.grad, want[1], "d/dFvar")
