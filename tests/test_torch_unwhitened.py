"""The unwhitened SVGP / SMGP of modulatedgps_tpu_torch against the JAX
package: the transposed TRSM (#4's plain version), the solve and Cholesky
autograd Functions, base_conditional(white=False), gauss_kl with the prior
covariance, the precomputed unwhitened posterior, the SMGP's loss, raw-leaf
gradients and Adam steps, and leading batch dimensions in predict_f.

Tolerances:
- f32 solves against the JAX Pallas TRSM in interpret mode: each compared
  with the f64 solve at rtol 2e-3, atol 2e-3 of max|X| (the bound of the
  JAX suite's own Pallas TRSM tests, tests/test_pallas_linalg.py); their
  gradients against the Pallas VJP at rtol 5e-3, atol 5e-3 of the largest
  magnitude (tests/test_pallas_linalg.py:185-203).
- f64 against JAX: rtol 1e-9, atol 1e-9 of each output's largest
  magnitude, the tolerance of tests/test_torch_train.py.  Both packages
  solve by substitution in f64; they differ in summation order only.
- The whiten-consistency identity (tests/test_models.py:53-72): rtol 1e-6
  in f64, as there.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import scipy.linalg
import torch

from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.models import SMGP as JSMGP
from modulatedgps_tpu.models import SVGP as JSVGP
from modulatedgps_tpu.models.posterior import precompute_smgp as j_precompute
from modulatedgps_tpu.ops import conditionals as jc
from modulatedgps_tpu.ops import kl as jkl
from modulatedgps_tpu.ops import pallas_linalg as PL
from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE
from modulatedgps_tpu.training.loop import make_train_step as j_make_train_step

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.ops import conditionals as tc
from modulatedgps_tpu_torch.ops import kl as tkl
from modulatedgps_tpu_torch.ops import linalg as tl
from modulatedgps_tpu_torch.ops.trsm_kernel import trsm_lower_t

M, K, D, N, S = 48, 3, 2, 40, 4
NUM_DATA, LR, STEPS = 100, 5e-3, 3
RTOL = 1e-9


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


def _chol_factor(M_, seed=0, jitter=1e-2):
    rng = np.random.default_rng(seed)
    Z = rng.uniform(-3, 3, size=(M_, 4))
    d2 = ((Z[:, None, :] - Z[None, :, :]) ** 2).sum(-1)
    return np.linalg.cholesky(np.exp(-0.5 * d2 / 0.5 ** 2)
                              + jitter * np.eye(M_))


def _gram(rng, M_, N_, ls=0.7, jitter=1e-6):
    Z, X = rng.normal(size=(M_, 2)), rng.normal(size=(N_, 2))
    d2 = lambda a, b: ((a[:, None] - b[None]) ** 2).sum(-1)
    k = lambda a, b: np.exp(-0.5 * d2(a, b) / ls ** 2)
    return k(Z, Z) + jitter * np.eye(M_), k(Z, X), k(X, X)


# ------------------------------------------------------------ trsm_lower_t

@pytest.mark.parametrize("M_,Nb", [(384, 300), (200, 77)])
def test_trsm_lower_t_matches_pallas_interpret(M_, Nb):
    """L^T X = B (f32) against the JAX Pallas backward substitution in
    interpret mode and the f64 solve; L's upper triangle holds NaN, which
    neither reads."""
    rng = np.random.default_rng(1)
    L = _chol_factor(M_, seed=1).astype(np.float32)
    B = rng.normal(size=(M_, Nb)).astype(np.float32)
    want = np.asarray(PL.solve_triangular_blocked(
        jnp.asarray(L), jnp.asarray(B), True, True, True))
    L_nan = L.copy()
    L_nan[np.triu_indices(M_, 1)] = np.nan
    got = trsm_lower_t(torch.as_tensor(L_nan), torch.as_tensor(B)).numpy()
    truth = scipy.linalg.solve_triangular(L.astype(np.float64), B, lower=True,
                                          trans="T")
    scale = np.abs(truth).max()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, truth, rtol=2e-3, atol=2e-3 * scale)
    np.testing.assert_allclose(want, truth, rtol=2e-3, atol=2e-3 * scale)


@pytest.mark.parametrize("trans", [False, True])
def test_solve_lower_gradients_match_pallas_vjp(trans):
    """solve_lower's autograd Function against solve_triangular_blocked's
    custom VJP (interpret mode) at f32, and against JAX autodiff of the
    exact solve at f64 (rtol 1e-9)."""
    rng = np.random.default_rng(2)
    L64 = _chol_factor(128, seed=2, jitter=1e-1)
    B64 = rng.normal(size=(128, 96))

    def jloss(solve):
        return lambda L, B: jnp.sum(jnp.sin(solve(L, B)))

    def tgrads(L, B):
        Lt = torch.tensor(L, requires_grad=True)
        Bt = torch.tensor(B, requires_grad=True)
        torch.sin(tl.solve_lower(Lt, Bt, trans=trans)).sum().backward()
        return Lt.grad.numpy(), Bt.grad.numpy()

    pallas = jloss(lambda L, B: PL.solve_triangular_blocked(L, B, True, trans,
                                                            True))
    L32, B32 = L64.astype(np.float32), B64.astype(np.float32)
    want = jax.grad(pallas, argnums=(0, 1))(jnp.asarray(L32), jnp.asarray(B32))
    for got, w in zip(tgrads(L32, B32), want):
        w = np.asarray(w)
        np.testing.assert_allclose(got, w, rtol=5e-3,
                                   atol=5e-3 * np.abs(w).max())
    exact = jloss(lambda L, B: jax.lax.linalg.triangular_solve(
        L, B, left_side=True, lower=True, transpose_a=trans))
    want = jax.grad(exact, argnums=(0, 1))(jnp.asarray(L64), jnp.asarray(B64))
    got = tgrads(L64, B64)
    _close(np.tril(got[0]), np.tril(np.asarray(want[0])))
    assert not np.triu(got[0], 1).any()
    _close(got[1], want[1])


def test_solve_lower_rank3_rhs_is_one_wide_solve():
    """A [K, M, Nb] right side is solved as one [M, K*Nb] one: the same
    values and gradients as K separate solves."""
    rng = np.random.default_rng(3)
    L = torch.tensor(_chol_factor(20, seed=3), requires_grad=True)
    B = torch.tensor(rng.normal(size=(3, 20, 7)), requires_grad=True)
    X = tl.solve_lower(L, B)
    w = torch.as_tensor(rng.normal(size=X.shape))
    (w * X).sum().backward()
    gL, gB = L.grad.clone(), B.grad.clone()
    L.grad = B.grad = None
    Xs = torch.stack([torch.linalg.solve_triangular(L, b, upper=False)
                      for b in B])
    (w * Xs).sum().backward()
    _close(X.detach().numpy(), Xs.detach().numpy())
    _close(torch.tril(gL).numpy(), torch.tril(L.grad).numpy())
    _close(gB.numpy(), B.grad.numpy())


def test_cholesky_gradient_matches_jax_f64():
    """A dense use of L (its upper triangle gets a cotangent too) against
    JAX autodiff of jnp.linalg.cholesky: Murray's pullback on the TRSM
    inverse and the banded products, symmetric, at rtol 1e-9."""
    rng = np.random.default_rng(4)
    Kmm, _, _ = _gram(rng, 30, 1, jitter=1e-3)
    W = rng.normal(size=(30, 30))

    def jloss(K_):
        L = jnp.linalg.cholesky(K_)
        return jnp.sum(W * L) + jnp.sum(jnp.sin(L @ L.T @ W))

    want = np.asarray(jax.grad(jloss)(jnp.asarray(Kmm)))
    Kt = torch.tensor(Kmm, requires_grad=True)
    L = tl.cholesky(Kt)
    Wt = torch.as_tensor(W)
    ((Wt * L).sum() + torch.sin(L @ L.T @ Wt).sum()).backward()
    _close(Kt.grad.numpy(), want)
    assert torch.equal(Kt.grad, Kt.grad.T)


# -------------------------------------------------------- conditional, KL

@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("form", ["tril", "diag", "none"])
def test_base_conditional_unwhitened_matches_jax_f64(form, full_cov):
    """Values and gradients (a seeded weighted sum of mean and variance) of
    base_conditional(white=False) against JAX, f64, rtol 1e-9."""
    rng = np.random.default_rng(5)
    Kmm, Kmn, Kxx = _gram(rng, M, N)
    Knn = Kxx if full_cov else np.diag(Kxx).copy()
    q_mu = rng.normal(size=(M, K))
    q_sqrt = {"tril": rng.normal(size=(K, M, M)),
              "diag": rng.uniform(0.1, 1.0, size=(M, K)),
              "none": None}[form]
    inputs = [Kmn, Kmm, q_mu] + ([] if q_sqrt is None else [q_sqrt])
    wm = rng.normal(size=(N, K))
    wv = rng.normal(size=(K, N, N) if full_cov else (N, K))

    def jloss(Kmn_, Kmm_, q_mu_, *q):
        m, v = jc.base_conditional(Kmn_, Kmm_, jnp.asarray(Knn), q_mu_,
                                   q_sqrt=q[0] if q else None,
                                   full_cov=full_cov, white=False)
        return jnp.sum(wm * m) + jnp.sum(wv * v), (m, v)

    (_, (mj, vj)), gj = jax.value_and_grad(
        jloss, argnums=tuple(range(len(inputs))), has_aux=True)(
            *map(jnp.asarray, inputs))
    ts = [torch.tensor(a, requires_grad=True) for a in inputs]
    mt, vt = tc.base_conditional(ts[0], ts[1], torch.as_tensor(Knn), ts[2],
                                 q_sqrt=ts[3] if q_sqrt is not None else None,
                                 full_cov=full_cov, white=False)
    ((torch.as_tensor(wm) * mt).sum() + (torch.as_tensor(wv) * vt).sum()
     ).backward()
    _close(mt.detach().numpy(), mj)
    _close(vt.detach().numpy(), vj)
    for t, g in zip(ts, gj):
        got, want = t.grad.numpy(), np.asarray(g)
        if t is ts[1]:      # Kmm: both symmetric pullbacks
            want = 0.5 * (want + want.T)
        _close(got, want)


@pytest.mark.parametrize("form", ["tril", "tril_assumed", "diag"])
def test_gauss_kl_with_prior_covariance_matches_jax_f64(form):
    rng = np.random.default_rng(6)
    Kmm, _, _ = _gram(rng, M, 1)
    q_mu = rng.normal(size=(M, K))
    if form == "diag":
        q_sqrt = rng.uniform(0.2, 1.0, size=(M, K))
    else:
        q_sqrt = np.tril(rng.normal(size=(K, M, M)), -1) + np.diag(
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


def test_whiten_consistency():
    """whitened(q) and unwhitened(Lm q) parameterize the same posterior and
    the same KL (tests/test_models.py:53-72, in the port), marginal and
    joint."""
    rng = np.random.default_rng(7)
    kern = pt.SquaredExponential.create(0.5, 0.5, dtype=torch.float64,
                                        device="cpu")
    Z = rng.normal(size=(7, 1))
    white = pt.SVGP.create(kern, Z, 1, dtype=torch.float64, device="cpu")
    plain = pt.SVGP.create(kern, Z, 1, whiten=False, dtype=torch.float64,
                           device="cpu")
    q_mu = rng.normal(size=(7, 1))
    q_sqrt = np.tril(rng.normal(size=(1, 7, 7)) * 0.2) + np.eye(7) * 0.7
    Lm = np.linalg.cholesky(white.kuu().detach().numpy())
    with torch.no_grad():
        white.q_mu.raw.copy_(torch.as_tensor(q_mu))
        white.q_sqrt.raw.copy_(torch.as_tensor(q_sqrt))
        plain.q_mu.raw.copy_(torch.as_tensor(Lm @ q_mu))
        plain.q_sqrt.raw.copy_(torch.as_tensor((Lm @ q_sqrt[0])[None]))
        X = torch.as_tensor(rng.normal(size=(5, 1)))
        for full_cov in (False, True):
            for a, b in zip(white.predict_f(X, full_cov=full_cov),
                            plain.predict_f(X, full_cov=full_cov)):
                np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=1e-6,
                                           atol=1e-8)
        np.testing.assert_allclose(float(plain.prior_kl()),
                                   float(white.prior_kl()), rtol=1e-6)


# ----------------------------------------------------------- SMGP, served

def _perturbed_layer(rng, variance, lengthscale):
    """A JAX layer at a whitened, perturbed state, carried to the equivalent
    unwhitened one (q_mu' = L q_mu, q_sqrt' = L q_sqrt), as chip_smoke's
    path A builds it."""
    layer = JSVGP.create(JSE.create(variance, lengthscale),
                         rng.normal(size=(M, D)), num_latent_gps=K,
                         whiten=False)
    q_mu = 0.5 * rng.normal(size=(M, K))
    q_sqrt = np.eye(M)[None] + 0.05 * np.tril(rng.normal(size=(K, M, M)))
    idx = np.arange(M)
    q_sqrt[:, idx, idx] = np.abs(q_sqrt[:, idx, idx])
    L = np.linalg.cholesky(np.asarray(layer.kuu()))
    return layer.replace(q_mu=layer.q_mu.replace_raw(jnp.asarray(L @ q_mu)),
                         q_sqrt=layer.q_sqrt.replace_raw(jnp.asarray(L @ q_sqrt)))


def _leaves(tree):
    leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf) for path, leaf in leaves}


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
                              device="cpu", dtype=torch.float64, whiten=False)


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


def _assert_close(got, want):
    assert sorted(got) == sorted(want)
    for key in want:
        _close(got[key], want[key])


def test_unwhitened_loss_and_raw_gradients_match_jax(setup):
    jm, X, Y, z, g = setup
    assert not jm.pred_layer.whiten
    jloss, tloss = _losses(z, g)
    want_loss, jgrads = jax.value_and_grad(jloss)(jm, None, jnp.asarray(X),
                                                  jnp.asarray(Y))
    tm = _port(jm)
    assert not tm.pred_layer.whiten and not tm.assign_layer.whiten
    loss = tloss(tm, None, torch.as_tensor(X), torch.as_tensor(Y))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(want_loss),
                               rtol=RTOL)
    got = {name: p.grad.numpy() for name, p in tm.named_parameters()}
    _assert_close(got, _leaves(jgrads))
    for layer in (tm.pred_layer, tm.assign_layer):
        assert not torch.triu(layer.q_sqrt.raw.grad, 1).any()


def test_unwhitened_adam_steps_match_jax(setup):
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
        np.testing.assert_allclose(float(step(tm, None, Xt, Yt)), float(jl),
                                   rtol=RTOL)
    _assert_close(pt.smgp_to_numpy(tm), _leaves(state.model))
    for p, m, v, tril in zip(opt.params, opt.m, opt.v, opt.tril):
        if tril:
            for t in (p, m, v):
                assert not torch.triu(t, 1).any()


@pytest.mark.parametrize("route", ["train", "served"])
def test_unwhitened_predictions_match_jax(setup, route):
    """predict_y / predict_assign / predict_density of the unwhitened SMGP
    through the training-path conditional and precompute_smgp, against
    JAX's (whose served route folds Q = Kmm^-1 (S S^T - Kmm) Kmm^-1), f64."""
    jm, X, Y, _, _ = setup
    tm = _port(jm)
    if route == "served":
        jm, tm = j_precompute(jm), pt.precompute_smgp(tm)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    with torch.no_grad():
        got = (*tm.predict_y(Xt), tm.predict_assign(Xt),
               tm.predict_density(Xt, Yt))
    want = (*jm.predict_y(Xj), jm.predict_assign(Xj),
            jm.predict_density(Xj, Yj))
    for a, b in zip(got, want):
        _close(a.numpy(), b, rtol=1e-8)


def test_unwhitened_served_route_matches_training_path(setup):
    """The port's two routes agree on the unwhitened model: the cached
    alpha = Kmm^-1 q_mu and S' = L^-1 S against the two solves."""
    jm, X, _, _, _ = setup
    tm = _port(jm)
    Xt = torch.as_tensor(X)
    with torch.no_grad():
        for layer in ("pred_layer", "assign_layer"):
            served = pt.precompute_posterior(getattr(tm, layer))
            for a, b in zip(served.predict_f(Xt),
                            getattr(tm, layer).predict_f(Xt)):
                _close(a.numpy(), b.numpy(), rtol=1e-8)


@pytest.mark.parametrize("full_cov", [False, True])
@pytest.mark.parametrize("whiten", [True, False])
def test_predict_f_leading_batch_dims_match_jax(setup, whiten, full_cov):
    """Xnew [2, 3, N, D]: JAX vmaps the conditional over the leading
    dimensions; the port takes marginals on all points at once and a joint
    covariance per batch."""
    jm, X, _, _, _ = setup
    layer = jm.pred_layer.replace(whiten=whiten)
    rng = np.random.default_rng(8)
    Xb = rng.uniform(-3, 3, size=(2, 3, 9, D))
    mj, vj = layer.predict_f(jnp.asarray(Xb), full_cov=full_cov)
    tm = _port(jm)
    tm.pred_layer.whiten = whiten
    with torch.no_grad():
        mt, vt = tm.pred_layer.predict_f(torch.as_tensor(Xb),
                                         full_cov=full_cov)
    assert mt.shape == (2, 3, 9, K)
    assert vt.shape == ((2, 3, K, 9, 9) if full_cov else (2, 3, 9, K))
    _close(mt.numpy(), mj)
    _close(vt.numpy(), vj)


# -------------------------------------------------------------- chip_smoke

def test_chip_smoke_unwhitened_phase_runs_on_cpu():
    """chip_smoke's path A at a tiny size on CPU tensors: the unwhitened
    model serves what the whitened one does and trains with finite losses
    and exact zeros above the diagonal; only the launch checks fail, as the
    counts stay 0 off the card."""
    import chip_smoke
    chip_smoke.failures.clear()
    try:
        counts = chip_smoke.phase_unwhitened(pt, dev="cpu", M=48, batch=64,
                                             steps=2)
        assert set(counts) == set(chip_smoke.UNWHITENED_TRAIN_KERNELS)
        assert not any(counts.values())
        launch = [f for f in chip_smoke.failures if "launched 0 times" in f]
        assert len(launch) == len(chip_smoke.failures) == (
            len(chip_smoke.UNWHITENED_SERVING_KERNELS) + 1 + len(counts))
    finally:
        chip_smoke.failures.clear()


def test_unwhitened_arrays_carry_the_whitened_state():
    """chip_smoke.unwhitened_arrays: q_mu' = L q_mu and q_sqrt' = L q_sqrt
    with L the Cholesky factor of the layer's own Kuu at the f32 jitter."""
    import chip_smoke
    arrays, _ = chip_smoke.smgp_arrays(16)
    out = chip_smoke.unwhitened_arrays(arrays)
    model = chip_smoke.build_model(pt, arrays, "cpu", torch.float64,
                                   jitter=chip_smoke.JITTER)
    for name in ("pred_layer", "assign_layer"):
        L = np.linalg.cholesky(getattr(model, name).kuu().detach().numpy())
        _close(out[f"{name}.q_mu.raw"], L @ arrays[f"{name}.q_mu.raw"])
        _close(out[f"{name}.q_sqrt.raw"], L @ arrays[f"{name}.q_sqrt.raw"])


# ------------------------------------------ chip_smoke's path A tolerances

FAULTS = {"trsm_lower_t (#4)": "trsm_lower_t_plain",
          "trsm_lower (#2)": "trsm_lower_plain"}


@functools.lru_cache(maxsize=None)
def _ref_inputs():
    import chip_smoke
    arrays, rng = chip_smoke.smgp_arrays(chip_smoke.M_REF)
    S_, B, K_ = (chip_smoke.NUM_SAMPLES, chip_smoke.BATCH_REF,
                 chip_smoke.K_EXPERTS)
    X = rng.uniform(-3, 3, size=(B, chip_smoke.D_IN))
    Y = rng.normal(size=(B, 1))
    z = rng.normal(size=(S_, B, K_))
    g = rng.gumbel(size=(S_, B, K_))
    return chip_smoke.unwhitened_arrays(arrays), X, Y, z, g


@functools.lru_cache(maxsize=None)
def _ref_grads(dtype, temperature):
    import chip_smoke
    return chip_smoke.loss_and_grads(pt, *_ref_inputs(), "cpu", dtype,
                                     temperature, whiten=False)


def _ref_errors(got, temperature):
    import chip_smoke
    want = _ref_grads(torch.float64, temperature)
    return {name: float((got[name] - want[name]).abs().max()
                        / want[name].abs().max())
            for name in chip_smoke.UNWHITE_GRAD_TOL}


def test_f32_cpu_path_is_within_unwhite_grad_tol_of_f64():
    """chip_smoke's phase 12 holds the card's f32 gradients of the
    unwhitened SMGP (M=1024) to UNWHITE_GRAD_TOL of f64; the port's f32 CPU
    path, which runs each kernel's plain version with the same arithmetic,
    lies within it on every leaf phase 12 checks."""
    import chip_smoke
    for tau in chip_smoke.GRAD_TEMPERATURES:
        errs = _ref_errors(_ref_grads(torch.float32, tau), tau)
        over = {name: (err, chip_smoke.UNWHITE_GRAD_TOL[name])
                for name, err in errs.items()
                if err > chip_smoke.UNWHITE_GRAD_TOL[name]
                and (tau >= 1.0 or not name.startswith("assign_layer."))}
        assert not over, f"temperature {tau}: {over}"


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_scaled_solve_breaks_an_unwhite_tolerance(fault):
    """Scaling the output of either TRSM by 1.03 moves a gradient past
    UNWHITE_GRAD_TOL at temperature 1."""
    import chip_smoke
    from modulatedgps_tpu_torch.ops import trsm_kernel
    name = FAULTS[fault]
    plain = getattr(trsm_kernel, name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trsm_kernel, name, lambda *a: 1.03 * plain(*a))
        got = chip_smoke.loss_and_grads(pt, *_ref_inputs(), "cpu",
                                        torch.float32, 1.0, whiten=False)
    errs = _ref_errors(got, 1.0)
    assert any(err > chip_smoke.UNWHITE_GRAD_TOL[n] for n, err in errs.items()), \
        errs
