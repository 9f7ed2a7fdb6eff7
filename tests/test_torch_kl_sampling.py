"""The whitened KL and the sampling of modulatedgps_tpu_torch against the
JAX package.

gauss_kl (tril and diagonal q_sqrt) and its gradients are held against JAX
gauss_kl with the whitened prior at f64, rtol 1e-12: the same closed form,
summed in another order.  reparameterize takes the same z in both;
relaxed_one_hot and SMGP.W_from_noise take the same Gumbel noise (JAX's
draw is replaced by it).  The port's own Gumbel draws are checked against
the distribution's mean (Euler's gamma) and variance (pi^2 / 6), at four
standard errors of 2e5 draws.
"""
import math
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import kl as jkl
from modulatedgps_tpu.ops import sampling as jsampling

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.ops import kl, sampling

M, K = 12, 3


def _q(rng):
    q_mu = rng.normal(size=(M, K))
    Lq = np.tril(0.3 * rng.normal(size=(K, M, M)), -1) + np.eye(M)[None] * \
        rng.uniform(0.5, 1.5, size=(K, 1, M))
    return q_mu, Lq


@pytest.mark.parametrize("form", ["tril", "diag"])
def test_gauss_kl_and_gradients_match_jax(form):
    rng = np.random.default_rng(0)
    q_mu, q_sqrt = _q(rng)
    if form == "diag":
        q_sqrt = rng.uniform(0.3, 1.7, size=(M, K))
    want, jgrad = jax.value_and_grad(
        lambda m, s: jkl.gauss_kl(m, s, None, assume_tril=form == "tril"),
        argnums=(0, 1))(jnp.asarray(q_mu), jnp.asarray(q_sqrt))
    tm = torch.tensor(q_mu, requires_grad=True)
    ts = torch.tensor(q_sqrt, requires_grad=True)
    got = kl.gauss_kl(tm, ts)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-12)
    for g, ref in ((tm.grad, jgrad[0]), (ts.grad, jgrad[1])):
        np.testing.assert_allclose(g.numpy(), np.asarray(ref), rtol=1e-12,
                                   atol=1e-14)
    if form == "tril":
        assert not torch.triu(ts.grad, 1).any()


@pytest.mark.parametrize("dtype,jdtype", [(torch.float64, jnp.float64),
                                          (torch.float32, jnp.float32)])
def test_reparameterize_matches_jax(dtype, jdtype):
    rng = np.random.default_rng(1)
    mean, var = rng.normal(size=(7, K)), rng.uniform(0, 2, size=(7, K))
    z = rng.normal(size=(4, 7, K))
    want = jsampling.reparameterize(jnp.asarray(mean, jdtype),
                                    jnp.asarray(var, jdtype),
                                    jnp.asarray(z, jdtype))
    got = sampling.reparameterize(torch.as_tensor(mean, dtype=dtype),
                                  torch.as_tensor(var, dtype=dtype),
                                  torch.as_tensor(z, dtype=dtype))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               rtol=1e-12 if dtype == torch.float64 else 1e-6)
    assert sampling.reparameterize(got, None, None) is got


def test_relaxed_one_hot_matches_jax_with_the_same_noise():
    logits = np.random.default_rng(2).normal(size=(6, K))
    gen = torch.Generator().manual_seed(5)
    got = sampling.relaxed_one_hot(gen, torch.as_tensor(logits), 0.5)
    g = sampling.gumbel(torch.Generator().manual_seed(5), (6, K),
                        torch.float64)
    with mock.patch.object(jsampling.jax.random, "gumbel",
                           lambda key, shape, dtype: jnp.asarray(g.numpy())):
        want = jsampling.relaxed_one_hot(jax.random.PRNGKey(0),
                                         jnp.asarray(logits), 0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12)
    np.testing.assert_allclose(got.sum(-1).numpy(), 1.0, rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gumbel_draws_have_the_gumbel_moments(dtype):
    g = sampling.gumbel(torch.Generator().manual_seed(0), (200_000,), dtype)
    assert g.dtype == dtype and bool(torch.isfinite(g).all())
    n = g.numel()
    var = math.pi ** 2 / 6
    assert abs(float(g.double().mean()) - 0.5772156649) < 4 * math.sqrt(var / n)
    assert abs(float(g.double().var()) - var) < 4 * math.sqrt(var ** 2 * 4.4 / n)


def test_draw_noise_and_W_from_noise_match_jax():
    from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
    from modulatedgps_tpu.models import SMGP as JSMGP
    from modulatedgps_tpu.models import SVGP as JSVGP
    from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE

    rng = np.random.default_rng(3)
    D, N, S = 2, 9, 4
    layer = lambda: JSVGP.create(JSE.create(0.5, 0.7), rng.normal(size=(M, D)),
                                 num_latent_gps=K)
    jm = JSMGP(likelihood=JGaussian.create(0.5, D=K), pred_layer=layer(),
               assign_layer=layer(), K=K, num_samples=S, num_data=50)
    leaves = jax.tree_util.tree_flatten_with_path(jm)[0]
    arrays = {jax.tree_util.keystr(p, simple=True, separator="."): np.asarray(v)
              for p, v in leaves}
    tm = pt.smgp_from_numpy(arrays, K=K, num_samples=S, num_data=50,
                            temperature=1e-2, device="cpu", dtype=torch.float64)
    z1, g1 = tm.draw_noise(torch.Generator().manual_seed(7), N, S, torch.float64)
    z2, g2 = tm.draw_noise(torch.Generator().manual_seed(7), N, S, torch.float64)
    assert z1.shape == g1.shape == (S, N, K) and z1.dtype == torch.float64
    assert torch.equal(z1, z2) and torch.equal(g1, g2)
    X = rng.uniform(-2, 2, size=(N, D))
    want = jm.W_from_noise(jnp.asarray(X), jnp.asarray(z1.numpy()),
                           jnp.asarray(g1.numpy()))
    with torch.no_grad():
        got = tm.W_from_noise(torch.as_tensor(X), z1, g1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-12)
