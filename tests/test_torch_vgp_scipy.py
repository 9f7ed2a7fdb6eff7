"""The port's VGP and run_scipy against the JAX package's, on the CPU in
float64 (the small sets of tests/test_vgp_scipy.py).

The same numpy state, perturbed away from the init (q_mu random, q_sqrt
I + 0.1 tril noise with garbage above its diagonal, the kernel moved),
goes through both packages' VGP: the moments, the KL, the ELBO, the
predictions and every trainable raw leaf's gradient agree to rel 1e-10.
run_scipy runs JAX's four cases (the exact-GPR marginal, frozen leaves,
a custom quadratic, the Bernoulli 7-point set) from the same start in both
packages; the converged ELBOs and parameters agree to 1e-6.
"""
import importlib
import itertools
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.likelihoods import Bernoulli as JBernoulli
from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.models import VGP as JVGP
from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE
from modulatedgps_tpu.params import Module as JModule
from modulatedgps_tpu.params import Parameter as JParameter
from modulatedgps_tpu.params import set_trainable as jset_trainable
from modulatedgps_tpu.training import run_adam as jrun_adam
from modulatedgps_tpu.training import run_scipy as jrun_scipy

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.params import Parameter

F64 = dict(dtype=torch.float64, device="cpu")
X7 = np.array([2.0, 4, 7, 9, 17, 19, 21])[:, None]
Y7 = np.array([1.0, 1, 1, 1, 0, 0, 0])[:, None]


def _toy_regression(n=20, seed=0):
    rng = np.random.default_rng(seed)
    X = np.sort(rng.uniform(-3, 3, (n, 1)), axis=0)
    Y = np.sin(X) + 0.1 * rng.standard_normal((n, 1))
    return X, Y


def _leaves(tree):
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _jax_vgp(lik, X, Y, var=1.0, ls=1.0):
    jlik = JGaussian.create(0.1) if lik == "gaussian" else JBernoulli()
    return JVGP.create(JSE.create(var, ls), jlik, X, Y)


def _port_vgp(lik, X, Y, var=1.0, ls=1.0, arrays=None):
    plik = pt.Gaussian.create(0.1, **F64) if lik == "gaussian" else pt.Bernoulli()
    model = pt.VGP.create(pt.SquaredExponential.create(var, ls, **F64), plik,
                          X, Y, **F64)
    if arrays is not None:
        pt.load_numpy_(model, arrays)
    return model


def _perturbed(lik):
    """A JAX VGP away from its init, and its raw leaves."""
    X, Y = (X7, Y7) if lik == "bernoulli" else _toy_regression()
    model = _jax_vgp(lik, X, Y, var=1.3, ls=0.8)
    n = X.shape[0]
    rng = np.random.default_rng(1)
    q_sqrt = np.eye(n)[None] + 0.1 * rng.normal(size=(1, n, n))  # upper garbage
    idx = np.arange(n)
    q_sqrt[:, idx, idx] = np.abs(q_sqrt[:, idx, idx])
    model = model.replace(
        q_mu=model.q_mu.replace_raw(jnp.asarray(0.5 * rng.normal(size=(n, 1)))),
        q_sqrt=model.q_sqrt.replace_raw(jnp.asarray(q_sqrt)))
    return model, X, Y


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("lik", ["gaussian", "bernoulli"])
def test_values_match_jax(lik):
    jm, X, Y = _perturbed(lik)
    pm = _port_vgp(lik, X, Y, arrays=_leaves(jm))
    Xs = np.linspace(-4, 22, 9)[:, None] if lik == "bernoulli" \
        else np.linspace(-4, 4, 9)[:, None]
    Ys = (np.arange(9) % 2).astype(np.float64)[:, None]
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)
    with torch.no_grad():
        pairs = [(jm.q_moments(), pm.q_moments()),
                 (jm.prior_kl(), pm.prior_kl()), (jm.elbo(), pm.elbo()),
                 (jm.training_loss(), pm.training_loss()),
                 (jm.predict_f(jnp.asarray(Xs)), pm.predict_f(t(Xs))),
                 (jm.predict_f(jnp.asarray(Xs), full_cov=True),
                  pm.predict_f(t(Xs), full_cov=True)),
                 (jm.predict_y(jnp.asarray(Xs)), pm.predict_y(t(Xs))),
                 (jm.predict_log_density(jnp.asarray(Xs), jnp.asarray(Ys)),
                  pm.predict_log_density(t(Xs), t(Ys)))]
    for want, got in pairs:
        want = want if isinstance(want, tuple) else (want,)
        got = got if isinstance(got, tuple) else (got,)
        for w, g in zip(want, got):
            assert tuple(g.shape) == np.shape(w)
            assert _rel(g.numpy(), w) < 1e-10


@pytest.mark.parametrize("lik", ["gaussian", "bernoulli"])
def test_raw_leaf_gradients_match_jax(lik):
    jm, X, Y = _perturbed(lik)
    arrays = _leaves(jm)
    pm = _port_vgp(lik, X, Y, arrays=arrays)
    # the port's parameters are the JAX leaves, in JAX's flatten order
    assert list(dict(pm.named_parameters())) == list(arrays)
    want = _leaves(jax.grad(lambda m: m.training_loss())(jm))
    pm.training_loss().backward()
    got = {n: p.grad.numpy() for n, p in pm.named_parameters() if p.requires_grad}
    assert set(got) == set(arrays) - {"X.raw", "Y.raw"}
    for name, g in got.items():
        assert _rel(g, want[name]) < 1e-10, name
    assert not np.triu(got["q_sqrt.raw"][0], 1).any()


def test_load_numpy_carries_a_jax_vgp():
    jm, X, Y = _perturbed("gaussian")
    arrays = _leaves(jm)
    pm = _port_vgp("gaussian", X, Y, arrays=arrays)
    for name, p in pm.named_parameters():
        np.testing.assert_array_equal(p.detach().numpy(), arrays[name])
    assert not pm.X.trainable and not pm.Y.trainable
    with pytest.raises(ValueError, match="missing"):
        pt.load_numpy_(pm, {k: v for k, v in arrays.items() if k != "Y.raw"})


def test_init_kl_zero_and_predict_f_near_q_moments():
    X, Y = _toy_regression()
    m = _port_vgp("gaussian", X, Y)
    assert float(m.prior_kl().detach()) == pytest.approx(0.0, abs=1e-10)
    with torch.no_grad():
        m.q_mu.raw.copy_(0.3 * torch.as_tensor(
            np.random.default_rng(1).normal(size=m.q_mu.shape)))
        fm1, fv1 = m.q_moments()
        fm2, fv2 = m.predict_f(m.X.value)
    # the conditional's Kmm has the jitter and its Kmn not: ~sqrt(jitter)
    np.testing.assert_allclose(fm1.numpy(), fm2.numpy(), atol=1e-3)
    np.testing.assert_allclose(fv1.numpy(), fv2.numpy(), atol=1e-3)


def _scipy_pair(jm, pm, maxiter, jloss=None, ploss=None):
    jm, jres = jrun_scipy(jm, jloss, maxiter=maxiter)
    out, pres = pt.run_scipy(pm, ploss, maxiter=maxiter)
    assert out is pm
    return jm, jres, pres


def test_run_scipy_reaches_the_exact_gpr_marginal_as_jax():
    X, Y = _toy_regression()
    jm = _jax_vgp("gaussian", X, Y)
    jm = jm.replace(kernel=jm.kernel.replace(
        variance=jset_trainable(jm.kernel.variance, False),
        lengthscales=jset_trainable(jm.kernel.lengthscales, False)),
        likelihood=jm.likelihood.replace(
            variance=jset_trainable(jm.likelihood.variance, False)))
    pm = _port_vgp("gaussian", X, Y)
    for p in (pm.kernel.variance, pm.kernel.lengthscales, pm.likelihood.variance):
        pt.set_trainable(p, False)
    jm, jres, pres = _scipy_pair(jm, pm, 800)
    K = np.asarray(JSE.create(1.0, 1.0).K(jnp.asarray(X))) + 0.1 * np.eye(20)
    L = np.linalg.cholesky(K)
    a = np.linalg.solve(L, Y)
    lml = float(-0.5 * np.sum(a ** 2) - np.sum(np.log(np.diag(L)))
                - 10 * np.log(2 * np.pi))
    with torch.no_grad():
        elbo = float(pm.elbo())
    assert elbo == pytest.approx(lml, abs=2e-4) and elbo <= lml + 1e-6
    assert abs(elbo - float(jm.elbo())) < 1e-6
    for name, p in pm.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), _leaves(jm)[name],
                                   atol=1e-6)


def test_run_scipy_leaves_frozen_leaves_as_jax():
    X, Y = _toy_regression()
    jm = _jax_vgp("gaussian", X, Y, var=2.0, ls=0.7)
    jm = jm.replace(kernel=jm.kernel.replace(
        lengthscales=jset_trainable(jm.kernel.lengthscales, False)))
    pm = _port_vgp("gaussian", X, Y, var=2.0, ls=0.7)
    pt.set_trainable(pm.kernel.lengthscales, False)
    with torch.no_grad():
        pm.q_sqrt.raw.add_(torch.triu(torch.ones_like(pm.q_sqrt.raw), 1))
    before = {n: p.detach().clone() for n, p in pm.named_parameters()}
    jm, jres, pres = _scipy_pair(jm, pm, 50)
    for name in ("kernel.lengthscales.raw", "X.raw", "Y.raw"):
        assert torch.equal(dict(pm.named_parameters())[name], before[name])
    assert torch.equal(torch.triu(pm.q_sqrt.raw.detach(), 1),
                       torch.triu(before["q_sqrt.raw"], 1))
    assert not torch.allclose(pm.q_mu.raw.detach(), before["q_mu.raw"])
    assert pres.nit == jres.nit
    assert abs(pres.fun - float(jres.fun)) < 1e-6
    for name in ("q_mu.raw", "kernel.variance.raw", "likelihood.variance.raw"):
        np.testing.assert_allclose(dict(pm.named_parameters())[name]
                                   .detach().numpy(), _leaves(jm)[name],
                                   atol=1e-6)


def test_run_scipy_custom_loss_as_jax():
    class JQuad(JModule):
        w: JParameter

    class Quad(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.w = Parameter(torch.zeros(3, dtype=torch.float64))

    target, scale = np.array([1.5, -2.0, 0.25]), np.array([1.0, 10.0, 100.0])
    tt, ts = torch.as_tensor(target), torch.as_tensor(scale)
    pm = Quad()
    jm, jres, pres = _scipy_pair(
        JQuad(w=JParameter(jnp.zeros(3))), pm, 200,
        lambda m: jnp.sum(jnp.square(m.w.value - target) * scale),
        lambda m: ((m.w.value - tt).square() * ts).sum())
    np.testing.assert_allclose(pm.w.value.detach().numpy(), target, atol=1e-6)
    np.testing.assert_allclose(pm.w.value.detach().numpy(),
                               np.asarray(jm.w.value), atol=1e-6)
    assert pres.success and jres.success
    # data= threads arrays through the loss as arguments
    model, res = pt.run_scipy(
        Quad(), lambda m, t, s: ((m.w.value - t).square() * s).sum(),
        data=(target, scale), maxiter=200)
    np.testing.assert_allclose(model.w.value.detach().numpy(), target, atol=1e-6)
    with pytest.raises(ValueError, match="no trainable"):
        pt.run_scipy(Quad().requires_grad_(False), lambda m: m.w.value.sum())


def test_run_scipy_bernoulli_classifies_as_jax():
    jm = _jax_vgp("bernoulli", X7, Y7)
    pm = _port_vgp("bernoulli", X7, Y7)
    with torch.no_grad():
        elbo0 = float(pm.elbo())
    jm, jres, pres = _scipy_pair(jm, pm, 500)
    with torch.no_grad():
        elbo = float(pm.elbo())
        p, _ = pm.predict_y(torch.as_tensor(X7))
    p = p.numpy().ravel()
    assert elbo > elbo0 and abs(elbo - float(jm.elbo())) < 1e-6
    assert np.all(p[:4] > 0.5) and np.all(p[4:] < 0.5)
    jp = np.asarray(jm.predict_y(jnp.asarray(X7))[0]).ravel()
    np.testing.assert_allclose(p, jp, atol=1e-6)


def test_two_run_adam_steps_drive_a_vgp_as_jax():
    jm, X, Y = _perturbed("gaussian")
    pm = _port_vgp("gaussian", X, Y, arrays=_leaves(jm))
    jm, _, jelbos = jrun_adam(jm, 2, itertools.repeat((jnp.asarray(X),
                                                       jnp.asarray(Y))),
                              1e-2, log_every=1, verbose=False,
                              use_fused_adam=False)
    t = (torch.as_tensor(X), torch.as_tensor(Y))
    pm, _, pelbos = pt.run_adam(pm, 2, itertools.repeat(t), 1e-2, log_every=1,
                                verbose=False)
    np.testing.assert_allclose(pelbos, jelbos, rtol=1e-10)
    want = _leaves(jm)
    for name, p in pm.named_parameters():
        assert _rel(p.detach().numpy(), want[name]) < 1e-10, name


def test_demo_driver_prints_jax_probabilities(capsys, monkeypatch):
    from modulatedgps_tpu_torch.demos import demo_vgp_bernoulli
    out = demo_vgp_bernoulli.main(["--platform", "cpu", "--no-plot",
                                   "--iters", "60"])
    port_line = [ln for ln in capsys.readouterr().out.splitlines()
                 if ln.startswith("p(y=1|x):")]
    demos = str(Path(__file__).resolve().parents[1] / "demos")
    monkeypatch.syspath_prepend(demos)
    monkeypatch.setattr(sys, "argv", ["demo_vgp_bernoulli.py", "--platform",
                                      "cpu", "--no-plot", "--iters", "60"])
    importlib.import_module("demo_vgp_bernoulli").main()
    jax_line = [ln for ln in capsys.readouterr().out.splitlines()
                if ln.startswith("p(y=1|x):")]
    parse = lambda ln: np.array(ln.split("[")[1].rstrip("]").split(), float)
    assert len(port_line) == len(jax_line) == 1
    np.testing.assert_allclose(parse(port_line[0]), parse(jax_line[0]),
                               atol=1e-5)
    # the unrounded probabilities against JAX's run of the same demo
    jm, _ = jrun_scipy(_jax_vgp("bernoulli", X7, Y7), maxiter=60)
    np.testing.assert_allclose(
        out["p"], np.asarray(jm.predict_y(jnp.asarray(X7))[0]).ravel(),
        atol=1e-5)


def test_demo_driver_refuses_gpu_without_a_card(monkeypatch):
    from modulatedgps_tpu_torch.demos import demo_vgp_bernoulli
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit) as exc:
        demo_vgp_bernoulli.main(["--platform", "gpu", "--no-plot"])
    assert exc.value.code not in (0, None)
