"""The port's config and params API, SVGP's small API, sgp_conditional and
reparameterize(full_cov=True) against the JAX package, on the CPU.

set_default_jitter, config_context and enable_debug_checks change the same
settings JAX's do (the jitter per dtype; the default float; torch's
anomaly mode where JAX sets jax_debug_nans); set_trainable, trainable_mask
and print_summary give JAX's flags and table rows for the same model;
SVGP.num_inducing and kuu(jitter) equal JAX's; sgp_conditional and the
full-covariance reparameterize equal JAX's at float64, rtol 1e-9 (atol
1e-9 of the output's largest magnitude).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu import config as jconfig
from modulatedgps_tpu import params as jparams
from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.likelihoods import MultiClass as JMultiClass
from modulatedgps_tpu.models import SMGPModified as JSMGPModified
from modulatedgps_tpu.models import SVGP as JSVGP
from modulatedgps_tpu.ops import conditionals as jcond
from modulatedgps_tpu.ops import kernels as jk
from modulatedgps_tpu.ops import mean_functions as jmf
from modulatedgps_tpu.ops import sampling as jsampling

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch import config
from modulatedgps_tpu_torch.ops import conditionals, sampling
from modulatedgps_tpu_torch.ops import mean_functions as tmf

RTOL = 1e-9
F64 = dict(dtype=torch.float64, device="cpu")


def _close(got, want, what=""):
    got, want = got.detach().numpy(), np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    atol = RTOL * max(float(np.abs(want).max()), 1e-300)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=atol, err_msg=what)


def _leaves(tree):
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


@pytest.fixture
def saved_config():
    """Both packages' module state, restored after the test."""
    ours = (config._CONFIG.jitter, config._CONFIG.jitter_f32,
            config._CONFIG.float_override)
    theirs = (jconfig._CONFIG.jitter, jconfig._CONFIG.jitter_f32,
              jconfig._CONFIG.float_override)
    yield
    (config._CONFIG.jitter, config._CONFIG.jitter_f32,
     config._CONFIG.float_override) = ours
    (jconfig._CONFIG.jitter, jconfig._CONFIG.jitter_f32,
     jconfig._CONFIG.float_override) = theirs


def _jitters():
    return ((config.default_jitter(torch.float64),
             config.default_jitter(torch.float32)),
            (jconfig.default_jitter(jnp.float64),
             jconfig.default_jitter(jnp.float32)))


@pytest.mark.parametrize("value,floor", [(1e-5, None), (1e-3, None),
                                         (1e-8, 1e-6)])
def test_set_default_jitter_matches_jax(saved_config, value, floor):
    config.set_default_jitter(value, f32_floor=floor)
    jconfig.set_default_jitter(value, f32_floor=floor)
    ours, theirs = _jitters()
    assert ours == theirs
    layer = pt.SVGP.create(pt.SquaredExponential.create(**F64),
                           np.zeros((3, 1)), **F64)
    np.testing.assert_array_equal(
        torch.diagonal(layer.kuu()).detach().numpy(), np.full(3, 1.0 + value))


def test_config_context_sets_and_restores(saved_config):
    before = _jitters()
    with config.config_context(jitter=3e-5, float_override=torch.float64), \
            jconfig.config_context(jitter=3e-5, float_override=jnp.float64):
        ours, theirs = _jitters()
        assert ours == theirs == (3e-5, 1e-4)
        assert config.default_float() == torch.float64
        assert config.default_jitter() == 3e-5
        # create methods given no dtype take the default float
        kern = pt.SquaredExponential.create(device="cpu")
        lik = pt.Gaussian.create(0.5, D=3, device="cpu")
        layer = pt.SVGP.create(kern, np.zeros((4, 2)), 2, device="cpu")
        mean = tmf.Linear.create(np.ones((2, 2)), device="cpu")
        for p in (*kern.parameters(), *lik.parameters(), *layer.parameters(),
                  *mean.parameters()):
            assert p.dtype == torch.float64
    assert _jitters() == before
    assert config.default_float() == torch.float32
    assert pt.White.create(device="cpu").variance.raw.dtype == torch.float32


def test_enable_debug_checks_turns_on_the_nan_check():
    try:
        config.enable_debug_checks()
        jconfig.enable_debug_checks()
        assert torch.is_anomaly_enabled() and torch.is_anomaly_check_nan_enabled()
        assert jax.config.jax_debug_nans
        x = torch.tensor([0.0], dtype=torch.float64, requires_grad=True)
        with pytest.raises(RuntimeError, match="nan"):
            (torch.sqrt(x) * 0.0).sum().backward()   # 0 * inf in the pullback
        config.enable_debug_checks(nans=False, checks=True)
        assert torch.is_anomaly_enabled()
        assert not torch.is_anomaly_check_nan_enabled()
        config.enable_debug_checks(nans=False)
        jconfig.enable_debug_checks(nans=False)
        assert not torch.is_anomaly_enabled() and not jax.config.jax_debug_nans
    finally:
        torch.autograd.set_detect_anomaly(False)
        jax.config.update("jax_debug_nans", False)


# -- params: set_trainable, trainable_mask, print_summary ------------------------

def _models():
    """The demo's model in both packages: SMGPModified with a
    Sum(Matern32, White) + Linear prediction layer and an SE assignment
    layer, White's variance and Z frozen."""
    rng = np.random.default_rng(0)
    M, K, D = 6, 3, 2
    Z, Za = rng.normal(size=(M, D)), rng.normal(size=(M, D))
    A = np.full((D, K), 0.2)
    jpred = JSVGP.create(jk.Sum(kernels=(jk.Matern32.create(1.0, 1.0),
                                        jk.White.create(0.01))),
                         Z, num_latent_gps=K,
                         mean_function=jmf.Linear.create(A, 0.1))
    white = jpred.kernel.kernels[1]
    jpred = jpred.replace(
        kernel=jpred.kernel.replace(kernels=(
            jpred.kernel.kernels[0],
            white.replace(variance=jparams.set_trainable(white.variance,
                                                         False)))),
        Z=jparams.set_trainable(jpred.Z, False))
    jm = JSMGPModified(likelihood=JMultiClass.create(K), pred_layer=jpred,
                       assign_layer=JSVGP.create(jk.SquaredExponential.create(),
                                                 Za, num_latent_gps=K),
                       assign_likelihood=JGaussian.create(0.5, D=K), K=K,
                       num_samples=2, num_data=10)
    pred = pt.SVGP.create(pt.Sum([pt.Matern32.create(1.0, 1.0, **F64),
                                  pt.White.create(0.01, **F64)]),
                          Z, num_latent_gps=K,
                          mean_function=tmf.Linear.create(A, 0.1, **F64),
                          **F64)
    pt.set_trainable(pred.kernel.kernels[1].variance, False)
    pt.set_trainable(pred.Z, False)
    tm = pt.SMGPModified(pt.MultiClass.create(K), pred,
                         pt.SVGP.create(pt.SquaredExponential.create(**F64),
                                        Za, num_latent_gps=K, **F64),
                         assign_likelihood=pt.Gaussian.create(0.5, D=K, **F64),
                         K=K, num_samples=2, num_data=10)
    return jm, tm


def test_set_trainable_changes_the_parameter_in_place():
    p = pt.params.Parameter.from_value(1.0, "positive", **F64)
    assert pt.set_trainable(p, False) is p
    assert not p.trainable and not p.raw.requires_grad
    pt.set_trainable(p, True)
    assert p.trainable
    jp = jparams.Parameter(1.0, transform="positive")
    assert jparams.set_trainable(jp, False).trainable is False


def test_trainable_mask_matches_jax():
    jm, tm = _models()
    want = {k: bool(v) for k, v in _leaves(jparams.trainable_mask(jm)).items()}
    got = pt.trainable_mask(tm)
    assert got == want
    assert sorted(k for k, v in got.items() if not v) == [
        "pred_layer.Z.raw", "pred_layer.kernel.kernels.1.variance.raw"]


def test_print_summary_rows_match_jax(capsys):
    jm, tm = _models()
    want = jparams.print_summary(jm)
    got = pt.print_summary(tm)
    assert got == want
    assert "model.pred_layer.kernel.kernels[1].variance" in got
    assert "model.assign_likelihood.variance" in got
    assert capsys.readouterr().out == want + "\n" + got + "\n"
    assert pt.print_summary(tm.pred_layer, "layer").splitlines()[1] \
        .startswith("layer.kernel.kernels[0].variance")


# -- SVGP's small API, sgp_conditional, reparameterize(full_cov=True) -----------

def _layer_pair(whiten=True, seed=1):
    rng = np.random.default_rng(seed)
    M, K, D = 9, 2, 2
    Z = rng.normal(size=(M, D))
    jl = JSVGP.create(jk.SquaredExponential.create(0.7, 0.9), Z,
                      num_latent_gps=K, whiten=whiten)
    q_sqrt = np.tril(0.3 * rng.normal(size=(K, M, M))) + 0.8 * np.eye(M)
    jl = jl.replace(q_mu=jl.q_mu.replace_raw(jnp.asarray(rng.normal(size=(M, K)))),
                    q_sqrt=jl.q_sqrt.replace_raw(jnp.asarray(q_sqrt)))
    tl = pt.SVGP.create(pt.SquaredExponential.create(0.7, 0.9, **F64), Z,
                        num_latent_gps=K, whiten=whiten, **F64)
    pt.load_numpy_(tl, _leaves(jl))
    return jl, tl, rng.normal(size=(7, D))


def test_num_inducing_and_kuu_jitter_match_jax():
    jl, tl, _ = _layer_pair()
    assert tl.num_inducing == jl.num_inducing == 9
    _close(tl.kuu(), jl.kuu(), "kuu()")
    _close(tl.kuu(jitter=0.25), jl.kuu(jitter=0.25), "kuu(0.25)")
    tl.jitter = 1e-3                    # the argument overrides the layer's
    _close(tl.kuu(jitter=0.25), jl.kuu(jitter=0.25), "kuu(0.25) over 1e-3")
    _close(tl.kuu(), jl.kuu(jitter=1e-3), "the layer's 1e-3")


@pytest.mark.parametrize("whiten", [True, False])
@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("kernel", ["se", "sum"])
def test_sgp_conditional_matches_jax(whiten, full_cov, kernel):
    jl, tl, X = _layer_pair(whiten)
    if kernel == "sum":
        jkern = jk.Sum(kernels=(jk.Matern52.create(0.6, 1.1),
                                jk.White.create(0.02)))
        tkern = pt.Sum([pt.Matern52.create(0.6, 1.1, **F64),
                        pt.White.create(0.02, **F64)])
    else:
        jkern, tkern = jl.kernel, tl.kernel
    args = dict(jitter=1e-5, full_cov=full_cov, white=whiten)
    want = jcond.sgp_conditional(jkern, jl.Z.value, jnp.asarray(X),
                                 jl.q_mu.value, jl.q_sqrt.value, **args)
    got = conditionals.sgp_conditional(tkern, tl.Z.value, torch.tensor(X),
                                       tl.q_mu.value, tl.q_sqrt.value, **args)
    _close(got[0], want[0], "fmean")
    _close(got[1], want[1], "fvar")


@pytest.mark.parametrize("lead", [(), (3,)])
def test_reparameterize_full_cov_matches_jax(lead):
    rng = np.random.default_rng(2)
    N, D = 6, 2
    mean = rng.normal(size=(*lead, N, D))
    B = rng.normal(size=(*lead, D, N, N))
    cov = np.moveaxis(B @ np.swapaxes(B, -1, -2) + 0.1 * np.eye(N), -3, -1)
    z = rng.normal(size=(*lead, N, D))
    want = jsampling.reparameterize(jnp.asarray(mean), jnp.asarray(cov),
                                    jnp.asarray(z), full_cov=True)
    got = sampling.reparameterize(torch.tensor(mean), torch.tensor(cov),
                                  torch.tensor(z), full_cov=True)
    _close(got, want, "full_cov draw")
    _close(sampling.reparameterize(torch.tensor(mean), torch.tensor(cov),
                                   torch.tensor(z), full_cov=True, jitter=0.3),
           jsampling.reparameterize(jnp.asarray(mean), jnp.asarray(cov),
                                    jnp.asarray(z), full_cov=True, jitter=0.3),
           "jitter 0.3")


def test_reparameterize_full_cov_gives_nan_for_a_failed_factor():
    """Output d = 1's covariance is indefinite at its third column: its
    factor is NaN from there on, so all its draws are NaN; output 0's are
    finite, and nothing raises."""
    N = 4
    cov = np.stack([np.eye(N), np.diag([1.0, 1.0, -1.0, 1.0])], axis=-1)
    out = sampling.reparameterize(torch.zeros(N, 2, dtype=torch.float64),
                                  torch.tensor(cov),
                                  torch.ones(N, 2, dtype=torch.float64),
                                  full_cov=True)
    assert torch.isfinite(out[:, 0]).all()
    assert torch.isnan(out[:, 1]).all()
