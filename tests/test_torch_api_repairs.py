"""Four API repairs of modulatedgps_tpu_torch, each against the JAX package.

- PrecomputedPosterior.predict_f takes Xnew [..., N, D] (leading
  dimensions flattened into one batch and restored) and raises
  NotImplementedError for full_cov=True, as JAX's does
  (modulatedgps_tpu/models/posterior.py:37-62); precompute_smgp's
  predict_y / predict_assign / predict_density accept [B, N, D].
- SVGP.predict_f_samples(full_cov=True) gives NaN, and raises nothing, on
  a joint covariance that is not positive definite, as JAX's does.
- run_adam(..., callback=cb) calls cb(i, elbo, state) at every log step,
  as modulatedgps_tpu/training/loop.py:192-193 does.
- Adam(model, lr, b1, b2, eps) matches JAX's FusedAdam(lr, b1, b2, eps)
  (its Pallas kernel in interpret mode) and optax.adam on a tril and a
  dense leaf; the defaults keep the bits of the fixed constants.

Tolerances: rtol 1e-9 in float64 where both packages compute the same
quantities in other summation orders (tests/test_torch_serving.py's
argument); Adam in f32 at rtol 1e-5, atol 5e-7, the JAX suite's own for
FusedAdam against optax (tests/test_torch_fused_adam.py).
"""
import importlib
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.models import SMGP as JSMGP
from modulatedgps_tpu.models import SVGP as JSVGP
from modulatedgps_tpu.models.posterior import precompute_smgp as j_precompute
from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE
from modulatedgps_tpu.training.loop import run_adam as j_run_adam

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.training import fused_adam

M, K, D, N, S = 16, 2, 2, 20, 3
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


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


@pytest.fixture(scope="module")
def models():
    rng = np.random.default_rng(0)
    jm = JSMGP(likelihood=JGaussian.create(0.5, D=K),
               pred_layer=_perturbed_layer(rng, 0.5, 0.5),
               assign_layer=_perturbed_layer(rng, 0.1, 1.0),
               K=K, num_samples=S, num_data=100)
    tm = pt.smgp_from_numpy(_leaves(jm), K=K, num_samples=S, num_data=100,
                            temperature=1e-2, device="cpu",
                            dtype=torch.float64)
    return jm, tm, rng


# --- 1. the batched served posterior ---------------------------------------

SERVED = ("pred_layer.mean", "pred_layer.var", "assign_layer.mean",
          "assign_layer.var", "predict_y.mean", "predict_y.var",
          "predict_assign", "predict_density")


@pytest.fixture(scope="module")
def served(models):
    jm, tm, rng = models
    X = rng.uniform(-3, 3, size=(3, 5, D))      # tests/test_models.py:201-209
    Y = rng.normal(size=(3, 5, 1))
    sj, st = j_precompute(jm), pt.precompute_smgp(tm)
    Xj, Xt = jnp.asarray(X), torch.as_tensor(X)
    out = {}
    with torch.inference_mode():
        for name in ("pred_layer", "assign_layer"):
            ft, fj = getattr(st, name).predict_f(Xt), getattr(sj, name).predict_f(Xj)
            out[f"{name}.mean"], out[f"{name}.var"] = (ft[0], fj[0]), (ft[1], fj[1])
            # each leading index is the unbatched call on that slice
            one = getattr(st, name).predict_f(Xt[1])
            assert torch.equal(ft[0][1], one[0]) and torch.equal(ft[1][1], one[1])
        yt, yj = st.predict_y(Xt), sj.predict_y(Xj)
        out["predict_y.mean"], out["predict_y.var"] = (yt[0], yj[0]), (yt[1], yj[1])
        out["predict_assign"] = (st.predict_assign(Xt), sj.predict_assign(Xj))
        out["predict_density"] = (st.predict_density(Xt, torch.as_tensor(Y)),
                                  sj.predict_density(Xj, jnp.asarray(Y)))
    return {k: (np.asarray(a), np.asarray(b)) for k, (a, b) in out.items()}


@pytest.mark.parametrize("case", SERVED)
def test_served_posterior_takes_batched_inputs_as_jax(served, case):
    got, want = served[case]
    lead = 1 if case.startswith("predict_y") else 0     # predict_y's [S, ...]
    assert got.shape[lead:lead + 2] == (3, 5)
    _close(got, want)


def test_served_posterior_full_cov_raises_as_jax(models):
    jm, tm, rng = models
    X = rng.uniform(-3, 3, size=(4, D))
    with pytest.raises(NotImplementedError, match="SVGP.predict_f"):
        j_precompute(jm).pred_layer.predict_f(jnp.asarray(X), full_cov=True)
    with pytest.raises(NotImplementedError, match="SVGP.predict_f"):
        pt.precompute_smgp(tm).pred_layer.predict_f(torch.as_tensor(X),
                                                    full_cov=True)


# --- 2. NaN, not an exception, from a covariance that is not PD ------------

def test_predict_f_samples_not_positive_definite_gives_nan_as_jax(models):
    """Latent 0's joint covariance is indefinite (eigenvalues 3 and -1 on
    its first two points), latent 1's is positive definite: both packages
    give NaN for every draw of latent 0 and finite draws of latent 1."""
    jm, tm, rng = models
    X = rng.uniform(-3, 3, size=(4, D))
    mean = rng.normal(size=(4, K))
    cov = np.stack([np.eye(4), np.eye(4)])
    cov[0, :2, :2] = [[1.0, 2.0], [2.0, 1.0]]
    with mock.patch.object(JSVGP, "predict_f",
                           lambda self, Xnew, full_cov=False:
                           (jnp.asarray(mean), jnp.asarray(cov))):
        fj = np.asarray(jm.pred_layer.predict_f_samples(
            jax.random.PRNGKey(0), jnp.asarray(X), 5))
    with mock.patch.object(pt.SVGP, "predict_f",
                           lambda self, Xnew, full_cov=False:
                           (torch.as_tensor(mean), torch.as_tensor(cov))):
        ft = tm.pred_layer.predict_f_samples(torch.Generator().manual_seed(0),
                                             torch.as_tensor(X), 5).numpy()
    assert ft.shape == fj.shape == (5, 4, K)
    for f in (ft, fj):
        assert np.isnan(f[..., 0]).all() and np.isfinite(f[..., 1]).all()


def test_predict_f_samples_nan_from_the_failed_column_on():
    """The factor behind the draws: NaN from the failed column on, per
    matrix, the columns before it the library's (cholesky_factor_plain's
    rule), and a positive definite matrix untouched."""
    from modulatedgps_tpu_torch.models.svgp import _cholesky_nan
    A = torch.eye(5, dtype=torch.float64).repeat(2, 1, 1)
    A[0, 2, 2] = -1.0
    L = _cholesky_nan(A)
    assert torch.isnan(L[0, :, 2:]).all() and torch.equal(L[0, :, :2],
                                                          A[0, :, :2])
    assert torch.equal(L[1], torch.eye(5, dtype=torch.float64))


# --- 3. run_adam's callback --------------------------------------------------

def test_run_adam_callback_matches_jax(models):
    """Both run_adams over the same deterministic loss (the ELBO of fixed
    numpy noise, patched in as training_loss) and the same batch: the
    callback is called at the same steps with the same ELBOs, and the
    port's state is the live run (step i, the model, its Adam)."""
    jm, tm0, rng = models
    tm = pt.smgp_from_numpy(_leaves(jm), K=K, num_samples=S, num_data=100,
                            temperature=1e-2, device="cpu",
                            dtype=torch.float64)
    X, Y = rng.uniform(-3, 3, size=(N, D)), rng.normal(size=(N, 1))
    z, g = rng.normal(size=(S, N, K)), rng.gumbel(size=(S, N, K))

    def j_loss(self, key, X, Y):
        kl = self.pred_layer.prior_kl() + self.assign_layer.prior_kl()
        return -(jnp.mean(self.E_log_p_Y_from_noise(
            X, Y, jnp.asarray(z), jnp.asarray(g))) - kl / self.num_data)

    def t_loss(self, generator, X, Y):
        kl = self.pred_layer.prior_kl() + self.assign_layer.prior_kl()
        return -(self.E_log_p_Y_from_noise(
            X, Y, torch.as_tensor(z), torch.as_tensor(g)).mean()
            - kl / self.num_data)

    j_calls, t_calls = [], []
    with mock.patch.object(JSMGP, "training_loss", j_loss):
        _, j_iters, j_elbos = j_run_adam(
            jm, 6, iter([(jnp.asarray(X), jnp.asarray(Y))] * 6), 5e-3,
            log_every=2, verbose=False, use_fused_adam=False,
            callback=lambda i, elbo, state: j_calls.append((i, elbo)))

    def t_callback(i, elbo, state):
        assert state.step == i and state.model is tm
        assert state.optimizer.count == i
        assert isinstance(state.generator, torch.Generator)
        t_calls.append((i, elbo))

    with mock.patch.object(pt.SMGP, "training_loss", t_loss):
        _, t_iters, t_elbos = pt.run_adam(
            tm, 6, iter([(torch.as_tensor(X), torch.as_tensor(Y))] * 6), 5e-3,
            log_every=2, verbose=False, callback=t_callback)
    assert [i for i, _ in t_calls] == [i for i, _ in j_calls] == [2, 4, 6]
    assert t_iters == j_iters and [e for _, e in t_calls] == t_elbos
    _close([e for _, e in t_calls], [e for _, e in j_calls])
    _close(t_elbos, j_elbos)


# --- 4. Adam's b1, b2 and eps -----------------------------------------------

B1, B2, EPS, LR, LEAF_M = 0.8, 0.99, 1e-6, 1e-2, 256


def _adam_inputs():
    rng = np.random.default_rng(3)
    q = rng.normal(size=(2, LEAF_M, LEAF_M)).astype(np.float32)
    w = rng.normal(size=(7,)).astype(np.float32)
    grads = [{"q": np.tril(rng.normal(size=q.shape)).astype(np.float32),
              "w": rng.normal(size=w.shape).astype(np.float32)}
             for _ in range(3)]
    return {"q": q, "w": w}, grads


def _jax_adam(params, grads, fused):
    """Three steps of FusedAdam (the q leaf through its Pallas kernel in
    interpret mode) or optax.adam at (B1, B2, EPS): the params, the
    moments and, for FusedAdam, the bias corrections its kernel got."""
    fa = importlib.import_module("modulatedgps_tpu.training.fused_adam")
    params = {k: jnp.asarray(v) for k, v in params.items()}
    corrs = []
    if not fused:
        opt = optax.adam(LR, b1=B1, b2=B2, eps=EPS)
        state = opt.init(params)
        for g in grads:
            updates, state = opt.update({k: jnp.asarray(v) for k, v in g.items()},
                                        state, params)
            params = optax.apply_updates(params, updates)
        return params, state[0].mu, state[0].nu, corrs
    opt = fa.FusedAdam(LR, b1=B1, b2=B2, eps=EPS)
    state = opt.init(params)
    orig, orig_adam = fa.pl.pallas_call, fa._pallas_adam

    def interpret(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    def spy(p, g, m, v, corr, **kw):
        corrs.append(tuple(float(c) for c in np.asarray(corr)))
        return orig_adam(p, g, m, v, corr, **kw)

    old_min = fa._FUSED_MIN_DIM
    try:
        fa._FUSED_MIN_DIM = LEAF_M
        fa.set_fused_dispatch(True)
        with mock.patch.object(fa.pl, "pallas_call", interpret), \
                mock.patch.object(fa, "_pallas_adam", spy):
            assert fa._eligible(params["q"])
            for g in grads:
                params, state = opt.update_and_apply(
                    {k: jnp.asarray(v) for k, v in g.items()}, state, params)
    finally:
        fa._FUSED_MIN_DIM = old_min
        fa.set_fused_dispatch(None)
    return params, state[0].mu, state[0].nu, corrs


def _port_adam(params, grads, corrs=None, **hyper):
    """The port's three steps through pt.Adam's routing (q as a "tril"
    Parameter, w elementwise); with ``corrs`` the bias corrections are
    JAX's kernel's (tests/test_torch_fused_adam.py's reason)."""
    model = torch.nn.Module()
    model.q = pt.params.Parameter(torch.tensor(params["q"]), "tril")
    model.w = pt.params.Parameter(torch.tensor(params["w"]))
    opt = pt.Adam(model, LR, **hyper)
    assert opt.tril == [True, False]
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        for t, g in enumerate(grads):
            opt.params[0].grad = torch.tensor(g["q"])
            opt.params[1].grad = torch.tensor(g["w"])
            if corrs is None:
                opt.step()
                continue
            c1, c2 = corrs[t]
            opt.count += 1
            for p, m, v, tril in zip(opt.params, opt.m, opt.v, opt.tril):
                h = (opt.b1, opt.b2, opt.eps)
                if tril:
                    fused_adam.adam_tril_(p.data, p.grad, m, v, LR, c1, c2, *h)
                else:
                    for old, new in zip((p.data, m, v), fused_adam.adam_update(
                            p.data, p.grad, m, v, LR, c1, c2, *h)):
                        old.copy_(new)
    finally:
        torch.set_num_threads(before)
    return {"q": (opt.params[0], opt.m[0], opt.v[0]),
            "w": (opt.params[1], opt.m[1], opt.v[1])}, opt


@pytest.mark.parametrize("reference", ["fused_adam", "optax"])
def test_adam_hyperparameters_match_jax(reference):
    params, grads = _adam_inputs()
    jp, jm, jv, corrs = _jax_adam(params, grads, reference == "fused_adam")
    if reference == "fused_adam":
        assert len(corrs) == 3
        own = [(1 / (1 - B1 ** t), 1 / (1 - B2 ** t)) for t in (1, 2, 3)]
        np.testing.assert_allclose(own, corrs, rtol=3e-5)
    got, opt = _port_adam(params, grads, corrs or None, b1=B1, b2=B2, eps=EPS)
    assert (opt.b1, opt.b2, opt.eps) == (B1, B2, EPS)
    for leaf in ("q", "w"):
        for t, want in zip(got[leaf], (jp[leaf], jm[leaf], jv[leaf])):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(want),
                                       rtol=1e-5, atol=5e-7,
                                       err_msg=f"{reference} {leaf}")
    q = got["q"][0].detach()
    assert torch.equal(torch.triu(q, 1), torch.triu(torch.tensor(params["q"]), 1))


def test_adam_defaults_keep_the_bits_of_the_fixed_constants():
    """Adam(model, lr) equals Adam(model, lr, 0.9, 0.999, 1e-8) bit for bit,
    and both equal the update written with the literal constants."""
    params, grads = _adam_inputs()
    default, _ = _port_adam(params, grads)
    explicit, _ = _port_adam(params, grads, b1=0.9, b2=0.999, eps=1e-8)
    p, m, v = (torch.tensor(params["w"]), torch.zeros(7), torch.zeros(7))
    for t, g in enumerate(grads, start=1):
        g = torch.tensor(g["w"])
        c1, c2 = 1.0 / (1.0 - 0.9 ** t), 1.0 / (1.0 - 0.999 ** t)
        m = 0.9 * m + (1.0 - 0.9) * g
        v = 0.999 * v + (1.0 - 0.999) * g * g
        p = p - LR * (m * c1) / (torch.sqrt(v * c2) + 1e-8)
    for leaf in ("q", "w"):
        for a, b in zip(default[leaf], explicit[leaf]):
            assert torch.equal(a, b), leaf
    for a, b in zip(default["w"], (p, m, v)):
        assert torch.equal(a.detach(), b)
