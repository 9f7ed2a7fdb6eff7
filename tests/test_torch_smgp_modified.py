"""The port's SMGPModified (MultiClass experts, a Gaussian likelihood on the
assignment layer) against the JAX package, on the CPU at float64.

One model of M=12 inducing points, K=3 classes (experts), D=2, N=30, S=4
at a perturbed state (q_mu ~ 0.5 N(0, 1), q_sqrt = I + 0.05 tril(N(0, 1))
with a positive diagonal, every other raw leaf moved by 0.1 N(0, 1)) is
built in JAX and in the port with the same constructors, the port's loaded
through load_numpy_ from jax.tree_util.tree_flatten_with_path.  Three
layer sets: both SquaredExponential (whitened, and unwhitened), and the
multiclass demo's prediction kernel Sum(Matern32, White) with a Linear
mean function over a SquaredExponential assignment layer.  The same numpy
noise (z, g) goes to both packages' E_log_p_Y_from_noise.

Checked: E_log_p_Y_from_noise, the loss (the negative ELBO with the
layers' KL) and every raw-leaf gradient against jax.value_and_grad;
precompute_smgp's SMGPModified serving equal to the training route and to
JAX's; predict_density equal to likelihood.predict_log_density; the
refusals of load_numpy_; Adam steps with frozen leaves (set_trainable)
against JAX's make_train_step, the frozen leaves bit-equal and #14's
wrapper never handed a frozen q_sqrt.

Tolerance: rtol 1e-9, atol 1e-9 of each leaf's largest magnitude, as
tests/test_torch_train.py.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.likelihoods import MultiClass as JMultiClass
from modulatedgps_tpu.models import SMGPModified as JSMGPModified
from modulatedgps_tpu.models import SVGP as JSVGP
from modulatedgps_tpu.models.posterior import precompute_smgp as j_precompute
from modulatedgps_tpu.ops import kernels as jk
from modulatedgps_tpu.ops import mean_functions as jmf
from modulatedgps_tpu.params import set_trainable as j_set_trainable
from modulatedgps_tpu.params import trainable_mask as j_trainable_mask
from modulatedgps_tpu.training.loop import make_train_step as j_make_train_step

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.ops import mean_functions as tmf

M, K, D, N, S = 12, 3, 2, 30, 4
NUM_DATA, LR = 100, 5e-3
RTOL = 1e-9
F64 = dict(dtype=torch.float64, device="cpu")
CONFIGS = ("se", "se_unwhitened", "sum_linear")


def _leaves(tree):
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _assert_close(got, want, what):
    assert sorted(got) == sorted(want)
    for key in want:
        atol = RTOL * max(np.abs(want[key]).max(), 1e-300)
        np.testing.assert_allclose(got[key], want[key], rtol=RTOL, atol=atol,
                                   err_msg=f"{what} {key}")


def _kernels(config, role):
    """(JAX kernel, the port's kernel, JAX mean function, the port's)."""
    if config == "sum_linear" and role == "pred":
        A = np.full((D, K), 0.2)
        return (jk.Sum(kernels=(jk.Matern32.create(1.0, 1.0),
                                jk.White.create(0.01))),
                pt.Sum([pt.Matern32.create(1.0, 1.0, **F64),
                        pt.White.create(0.01, **F64)]),
                jmf.Linear.create(A, 0.1), tmf.Linear.create(A, 0.1, **F64))
    var, ls = (0.5, 0.5) if role == "pred" else (0.1, 1.0)
    return (jk.SquaredExponential.create(var, ls),
            pt.SquaredExponential.create(var, ls, **F64), None, None)


def _perturb(layer, rng):
    q_mu = 0.5 * rng.normal(size=(M, K))
    q_sqrt = np.eye(M)[None] + 0.05 * np.tril(rng.normal(size=(K, M, M)))
    idx = np.arange(M)
    q_sqrt[:, idx, idx] = np.abs(q_sqrt[:, idx, idx])
    layer = layer.replace(q_mu=layer.q_mu.replace_raw(jnp.asarray(q_mu)),
                          q_sqrt=layer.q_sqrt.replace_raw(jnp.asarray(q_sqrt)))
    kernel, mean = layer.kernel, layer.mean_function
    leaves, treedef = jax.tree_util.tree_flatten(kernel)
    kernel = jax.tree_util.tree_unflatten(
        treedef, [x + 0.1 * rng.normal(size=np.shape(x)) for x in leaves])
    if mean is not None:
        leaves, treedef = jax.tree_util.tree_flatten(mean)
        mean = jax.tree_util.tree_unflatten(
            treedef, [x + 0.1 * rng.normal(size=np.shape(x)) for x in leaves])
    return layer.replace(kernel=kernel, mean_function=mean)


def build(config, seed=0):
    """(JAX SMGPModified, the port's with the same leaves, X, Y, z, g)."""
    rng = np.random.default_rng(seed)
    whiten = config != "se_unwhitened"
    jlayers, tlayers = [], []
    for role in ("pred", "assign"):
        jkern, tkern, jmean, tmean = _kernels(config, role)
        Z = rng.normal(size=(M, D))
        jlayers.append(_perturb(JSVGP.create(
            jkern, Z, num_latent_gps=K, whiten=whiten, mean_function=jmean),
            rng))
        tlayers.append(pt.SVGP.create(tkern, Z, num_latent_gps=K,
                                      whiten=whiten, mean_function=tmean,
                                      **F64))
    jm = JSMGPModified(likelihood=JMultiClass.create(K),
                       pred_layer=jlayers[0], assign_layer=jlayers[1],
                       assign_likelihood=JGaussian.create(0.5, D=K), K=K,
                       num_samples=S, num_data=NUM_DATA)
    jm = jm.replace(assign_likelihood=jm.assign_likelihood.replace(
        variance=jm.assign_likelihood.variance.replace_raw(
            jm.assign_likelihood.variance.raw
            + jnp.asarray(0.2 * rng.normal(size=(1, K))))))
    tm = pt.SMGPModified(pt.MultiClass.create(K), *tlayers,
                         assign_likelihood=pt.Gaussian.create(0.5, D=K, **F64),
                         K=K, num_samples=S, num_data=NUM_DATA)
    pt.load_numpy_(tm, _leaves(jm))
    X = rng.uniform(-3, 3, size=(N, D))
    Y = rng.integers(0, K, size=(N, 1))
    z = rng.normal(size=(S, N, K))
    g = rng.gumbel(size=(S, N, K))
    return jm, tm, X, Y, z, g


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


@pytest.mark.parametrize("config", CONFIGS)
@pytest.mark.parametrize("float_labels", [False, True])
def test_loss_and_raw_gradients_match_jax(config, float_labels):
    jm, tm, X, Y, z, g = build(config)
    if float_labels:
        Y = Y.astype(np.float64)
    jloss, tloss = _losses(z, g)
    Xj, Yj, Xt, Yt = (jnp.asarray(X), jnp.asarray(Y), torch.as_tensor(X),
                      torch.as_tensor(Y))
    e_want = jm.E_log_p_Y_from_noise(Xj, Yj, jnp.asarray(z), jnp.asarray(g))
    e_got = tm.E_log_p_Y_from_noise(Xt, Yt, torch.as_tensor(z),
                                    torch.as_tensor(g))
    _assert_close({"E": e_got.detach().numpy()}, {"E": np.asarray(e_want)},
                  "E_log_p_Y_from_noise")
    want_loss, jgrads = jax.value_and_grad(jloss)(jm, None, Xj, Yj)
    loss = tloss(tm, None, Xt, Yt)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=RTOL)
    got = {name: p.grad.numpy() for name, p in tm.named_parameters()}
    _assert_close(got, _leaves(jgrads), "gradient")
    assert np.abs(got["assign_likelihood.variance.raw"]).max() > 0
    assert np.abs(got["assign_layer.q_mu.raw"]).max() > 1e-8


def test_elbo_runs_and_matches_its_parts():
    """elbo(generator, ...) = mean E_log_p_Y - KL / num_data, with noise
    drawn as draw_noise draws it."""
    _, tm, X, Y, _, _ = build("se")
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    gen = lambda: torch.Generator().manual_seed(3)
    z, g = tm.draw_noise(gen(), N, S, torch.float64)
    kl = tm.pred_layer.prior_kl() + tm.assign_layer.prior_kl()
    want = tm.E_log_p_Y_from_noise(Xt, Yt, z, g).mean() - kl / NUM_DATA
    got = tm.elbo(gen(), Xt, Yt)
    assert torch.isfinite(got)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-12)


@pytest.mark.parametrize("config", CONFIGS)
def test_precompute_serves_an_smgp_modified_equal_to_the_training_route(config):
    jm, tm, X, Y, _, _ = build(config)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    served = pt.precompute_smgp(tm)
    assert type(served) is pt.SMGPModified
    assert served.assign_likelihood is tm.assign_likelihood
    assert (served.K, served.num_samples, served.num_data, served.temperature) \
        == (tm.K, tm.num_samples, tm.num_data, tm.temperature)
    assert type(tm.pred_layer) is pt.SVGP        # the original is unchanged
    jserved = j_precompute(jm)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    with torch.no_grad():
        for name, call, jcall in (
                ("predict_y", lambda m: m.predict_y(Xt, S=2),
                 lambda m: m.predict_y(Xj, S=2)),
                ("predict_assign", lambda m: (m.predict_assign(Xt),),
                 lambda m: (m.predict_assign(Xj),)),
                ("predict_density", lambda m: (m.predict_density(Xt, Yt),),
                 lambda m: (m.predict_density(Xj, Yj),))):
            for i, (a, b, c, d) in enumerate(zip(call(served), call(tm),
                                                 jcall(jserved), jcall(jm))):
                # JAX's served variance kᵀQk lands ~1e-11 off its own
                # training route at this size; the port's factor form is
                # held to JAX's training route
                for got, want, what in ((a, d, "served"), (b, d, "train")):
                    np.testing.assert_allclose(
                        got.numpy(), np.asarray(want), rtol=RTOL,
                        atol=RTOL * np.abs(np.asarray(want)).max(),
                        err_msg=f"{config} {name}[{i}] {what}")
                np.testing.assert_allclose(
                    np.asarray(c), np.asarray(d), rtol=1e-7,
                    err_msg=f"{config} {name}[{i}] JAX served")
        mean, _ = served.predict_y(Xt)
        np.testing.assert_allclose(mean.sum(-1).numpy(), 1.0, atol=2e-3)
        sy, sf = served.predict_samples(torch.Generator().manual_seed(0), Xt,
                                        S=5)
        assert sy.shape == sf.shape == (5, N, 1)
        assert torch.isfinite(sy).all() and torch.isfinite(sf).all()


def test_predict_density_is_the_likelihood_density():
    """Every MultiClass expert shares the one density and sum_k pi_k = 1, so
    predict_density == likelihood.predict_log_density (tests/test_models.py's
    check), within log(eps/(K-1)) and log(1-eps)."""
    _, tm, X, Y, _, _ = build("sum_linear")
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    with torch.no_grad():
        ld = tm.predict_density(Xt, Yt)
        Fmu, Fvar = tm.pred_layer.predict_f(Xt)
        direct = tm.likelihood.predict_log_density(Fmu, Fvar, Yt)
    np.testing.assert_allclose(ld.numpy(), direct.numpy(), rtol=1e-8)
    assert ld.shape == (N,)
    assert (ld <= np.log(1 - 1e-3) + 1e-12).all()
    assert (ld >= np.log(1e-3 / (K - 1))).all()


def test_load_numpy_refuses_missing_extra_and_misshapen_leaves():
    jm, tm, *_ = build("sum_linear")
    arrays = _leaves(jm)
    assert "pred_layer.kernel.kernels.0.variance.raw" in arrays
    assert "pred_layer.mean_function.A.raw" in arrays
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    missing = dict(arrays)
    missing.pop("assign_likelihood.variance.raw")
    extra = dict(arrays, **{"likelihood.variance.raw": np.zeros((1, K))})
    misshapen = dict(arrays, **{"pred_layer.Z.raw": np.zeros((M, D + 1))})
    for bad, match in ((missing, "missing"), (extra, "unexpected"),
                       (misshapen, "shape")):
        with pytest.raises(ValueError, match=match):
            pt.load_numpy_(tm, {**{k: v + 1.0 for k, v in bad.items()}})
        for n, p in tm.named_parameters():
            assert torch.equal(p, before[n]), n
    # a leading '.' in a key is ignored, as smgp_from_numpy does
    pt.load_numpy_(tm, {"." + k: v for k, v in arrays.items()})
    assert pt.smgp_to_numpy(tm).keys() == arrays.keys()


FROZEN = ("pred_layer.kernel.kernels.1.variance.raw", "pred_layer.Z.raw",
          "assign_layer.q_sqrt.raw")


def _freeze_jax(jm):
    pred, assign = jm.pred_layer, jm.assign_layer
    white = pred.kernel.kernels[1]
    kernel = pred.kernel.replace(kernels=(
        pred.kernel.kernels[0],
        white.replace(variance=j_set_trainable(white.variance, False))))
    pred = pred.replace(kernel=kernel, Z=j_set_trainable(pred.Z, False))
    assign = assign.replace(q_sqrt=j_set_trainable(assign.q_sqrt, False))
    return jm.replace(pred_layer=pred, assign_layer=assign)


def test_adam_with_frozen_leaves_matches_jax(monkeypatch):
    """The demo's freezing (White's variance and Z, gpflow's set_trainable)
    and a frozen q_sqrt: three Adam steps equal JAX's masked ones, the
    frozen leaves keep their bits, and the fused tril update is handed the
    trainable q_sqrt only."""
    from modulatedgps_tpu_torch.training import adam
    jm, tm, X, Y, z, g = build("sum_linear")
    jm = _freeze_jax(jm)
    for name in FROZEN:
        module = tm.get_submodule(name.removesuffix(".raw"))
        assert pt.set_trainable(module, False) is module
    mask = pt.trainable_mask(tm)
    assert mask == {k: bool(v)
                    for k, v in _leaves(j_trainable_mask(jm)).items()}
    assert [n for n, t in mask.items() if not t] == sorted(
        FROZEN, key=list(mask).index)
    before = {n: p.detach().clone() for n, p in tm.named_parameters()}
    handed = []
    real = adam.adam_tril_

    def spy(p, *args, **kwargs):
        handed.append(p)
        return real(p, *args, **kwargs)

    monkeypatch.setattr(adam, "adam_tril_", spy)
    jloss, tloss = _losses(z, g)
    init_fn, step_fn = j_make_train_step(optax.adam(LR), loss_fn=jloss)
    state = init_fn(jm, jax.random.PRNGKey(0))
    opt = pt.Adam(tm, LR)
    step = pt.make_train_step(opt, loss_fn=tloss)
    Xj, Yj, Xt, Yt = (jnp.asarray(X), jnp.asarray(Y), torch.as_tensor(X),
                      torch.as_tensor(Y))
    for _ in range(3):
        state, jl = step_fn(state, Xj, Yj)
        tl = step(tm, None, Xt, Yt)
        np.testing.assert_allclose(float(tl), float(jl), rtol=RTOL)
    _assert_close(pt.smgp_to_numpy(tm), _leaves(state.model), "after Adam")
    params = dict(tm.named_parameters())
    for name in FROZEN:
        assert torch.equal(params[name], before[name]), name
    assert not torch.equal(params["pred_layer.q_sqrt.raw"],
                           before["pred_layer.q_sqrt.raw"])
    assert len(handed) == 3
    assert all(p is params["pred_layer.q_sqrt.raw"] for p in handed)
