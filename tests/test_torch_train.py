"""The train step of modulatedgps_tpu_torch against the JAX package, f64.

One SMGP (M=64, K=3, D=2, N=50, S=4) at a perturbed state is built in JAX
and carried into the port through smgp_from_numpy (at the whitened init
the q_sqrt term cancels and the true Z gradient is exactly 0, so the state
is perturbed: q_mu ~ 0.5 N(0, 1), q_sqrt = I + 0.05 tril(N(0, 1)) with a
positive diagonal).  Both packages evaluate the ELBO loss with the same
numpy noise (z, g) through E_log_p_Y_from_noise and prior_kl, then take
three Adam steps (lr 5e-3) with that loss: JAX's make_train_step over
optax.adam, the port's make_train_step over its Adam.

Tolerance: rtol 1e-9 in float64, atol 1e-9 of each leaf's largest
magnitude.  The two packages compute the same quantities and differ only
in summation order and in the form of the solves (JAX substitutes, the
port multiplies by L^-1 and uses the fused whiten_solve pullback); at
jitter 1e-6 that moves values and gradients by well under 1e-9 of their
scale, and Adam's normalised update carries that over.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.models import SMGP as JSMGP
from modulatedgps_tpu.models import SVGP as JSVGP
from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE
from modulatedgps_tpu.training.loop import make_train_step as j_make_train_step

import modulatedgps_tpu_torch as pt

M, K, D, N, S = 64, 3, 2, 50, 4
NUM_DATA, LR, STEPS = 100, 5e-3, 3
RTOL = 1e-9


def _perturbed_layer(rng, variance, lengthscale):
    layer = JSVGP.create(JSE.create(variance, lengthscale),
                         rng.normal(size=(M, D)), num_latent_gps=K)
    q_mu = 0.5 * rng.normal(size=(M, K))
    q_sqrt = np.eye(M)[None] + 0.05 * np.tril(rng.normal(size=(K, M, M)))
    idx = np.arange(M)
    q_sqrt[:, idx, idx] = np.abs(q_sqrt[:, idx, idx])
    return layer.replace(q_mu=layer.q_mu.replace_raw(jnp.asarray(q_mu)),
                         q_sqrt=layer.q_sqrt.replace_raw(jnp.asarray(q_sqrt)))


def _leaves(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf) for path, leaf in leaves}


def _assert_close(got, want, what):
    assert sorted(got) == sorted(want)
    for key in want:
        atol = RTOL * max(np.abs(want[key]).max(), 1e-300)
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {key}")


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(0)
    jm = JSMGP(likelihood=JGaussian.create(0.5, D=K),
               pred_layer=_perturbed_layer(rng, 0.5, 0.5),
               assign_layer=_perturbed_layer(rng, 0.1, 1.0),
               K=K, num_samples=S, num_data=NUM_DATA)
    X = rng.uniform(-3, 3, size=(N, D))
    Y = rng.normal(size=(N, 1))
    z = rng.normal(size=(S, N, K))
    g = rng.gumbel(size=(S, N, K))
    return jm, X, Y, z, g


def _port(jm):
    return pt.smgp_from_numpy(_leaves(jm), K=K, num_samples=S,
                              num_data=NUM_DATA, temperature=1e-2,
                              device="cpu", dtype=torch.float64)


def _losses(z, g):
    zj, gj = jnp.asarray(z), jnp.asarray(g)
    zt, gt = torch.as_tensor(z), torch.as_tensor(g)

    def jloss(model, key, X, Y):
        kl = model.pred_layer.prior_kl() + model.assign_layer.prior_kl()
        return -(jnp.mean(model.E_log_p_Y_from_noise(X, Y, zj, gj))
                 - kl / model.num_data)

    def tloss(model, generator, X, Y):
        kl = model.pred_layer.prior_kl() + model.assign_layer.prior_kl()
        return -(model.E_log_p_Y_from_noise(X, Y, zt, gt).mean()
                 - kl / model.num_data)

    return jloss, tloss


def test_loss_and_raw_gradients_match_jax(setup):
    jm, X, Y, z, g = setup
    jloss, tloss = _losses(z, g)
    want_loss, jgrads = jax.value_and_grad(jloss)(jm, None, jnp.asarray(X),
                                                  jnp.asarray(Y))
    tm = _port(jm)
    loss = tloss(tm, None, torch.as_tensor(X), torch.as_tensor(Y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=RTOL)
    got = {name: p.grad.numpy() for name, p in tm.named_parameters()}
    _assert_close(got, _leaves(jgrads), "gradient")
    for layer in (tm.pred_layer, tm.assign_layer):
        assert np.abs(layer.Z.raw.grad.numpy()).max() > 1e-6
        assert not torch.triu(layer.q_sqrt.raw.grad, 1).any()


def test_adam_steps_match_jax(setup):
    jm, X, Y, z, g = setup
    jloss, tloss = _losses(z, g)
    init_fn, step_fn = j_make_train_step(optax.adam(LR), loss_fn=jloss)
    state = init_fn(jm, jax.random.PRNGKey(0))
    tm = _port(jm)
    opt = pt.Adam(tm, LR)
    step = pt.make_train_step(opt, loss_fn=tloss)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    for _ in range(STEPS):
        state, jl = step_fn(state, Xj, Yj)
        tl = step(tm, None, Xt, Yt)
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    _assert_close(pt.smgp_to_numpy(tm), _leaves(state.model), "after Adam")
    assert opt.count == STEPS
    names = {id(p): name for name, p in tm.named_parameters()}
    for p, m, v in zip(opt.params, opt.m, opt.v):
        name = names[id(p)]
        if name.endswith("q_sqrt.raw"):
            for t in (p, m, v):
                assert not torch.triu(t, 1).any(), name
            assert torch.diagonal(m, dim1=-2, dim2=-1).abs().min() > 0


def test_non_trainable_parameters_get_no_update(setup):
    jm, X, Y, z, g = setup
    _, tloss = _losses(z, g)
    tm = _port(jm)
    tm.pred_layer.Z.raw.requires_grad_(False)
    before = tm.pred_layer.Z.raw.clone()
    opt = pt.Adam(tm, LR)
    assert len(opt.params) == 10
    pt.make_train_step(opt, loss_fn=tloss)(tm, None, torch.as_tensor(X),
                                             torch.as_tensor(Y))
    assert torch.equal(tm.pred_layer.Z.raw, before)
    assert not torch.equal(tm.assign_layer.Z.raw, _port(jm).assign_layer.Z.raw)


def test_run_adam_raises_the_elbo_on_cpu(setup):
    jm, X, Y, _, _ = setup
    tm = _port(jm)
    batches = iter([(torch.as_tensor(X), torch.as_tensor(Y))] * 40)
    model, iters, elbos = pt.run_adam(tm, 40, batches, 2e-2, log_every=10,
                                      verbose=False)
    assert model is tm and iters == [10, 20, 30, 40]
    assert np.isfinite(elbos).all() and elbos[-1] > elbos[0]


def test_elbo_checks_num_data_and_shapes(setup):
    jm, X, Y, _, _ = setup
    tm = _port(jm)
    gen = torch.Generator().manual_seed(0)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    assert torch.isfinite(tm.elbo(gen, Xt, Yt))
    with pytest.raises(ValueError, match="conflicts"):
        tm.elbo(gen, Xt, Yt[:-1])
    tm.num_data = None
    with pytest.raises(ValueError, match="num_data"):
        tm.elbo(gen, Xt, Yt)


def test_chip_smoke_train_phase_runs_on_cpu():
    """chip_smoke's train phase at a tiny size on CPU tensors: finite
    losses and exact zeros above the diagonal of q_sqrt and its moments;
    only the launch checks fail, as the counts stay 0 off the card."""
    import chip_smoke
    chip_smoke.failures.clear()
    try:
        counts = chip_smoke.phase_train(pt, dev="cpu", M=64, batch=128, steps=3)
        assert set(counts) == set(chip_smoke.TRAIN_KERNELS)
        assert not any(counts.values())
        assert len(chip_smoke.failures) == len(counts)
        assert all("launched 0 times" in f for f in chip_smoke.failures)
    finally:
        chip_smoke.failures.clear()
