"""The JAX package's npz checkpoints read into the port, on the CPU in f64.

JAX's save_checkpoint writes a model-only file (SMGP, SMGPModified with
MultiClass experts, a plain SVGP) and, through run_adam's checkpoint_every,
a full TrainState after three Adam steps (optax's Adam and the fused one).
restore_jax_checkpoint reads them into port models built with the same
constructors: every leaf bit-equal to JAX's, Adam's moments, count and the
step equal; one more Adam step in each package at the same noise agrees to
1e-10 relative.  The leaf order (jax_leaf_names) is pinned against
jax.tree_util for SMGP, SMGPModified, SVGP and VGP, and a file that does
not fit raises ValueError and leaves the model as it was.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import modulatedgps_tpu as mgp
from modulatedgps_tpu.likelihoods import Bernoulli as JBernoulli
from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.likelihoods import MultiClass as JMultiClass
from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE
from modulatedgps_tpu.training import (make_train_step as jmake_train_step,
                                       restore_checkpoint as jrestore,
                                       run_adam as jrun_adam,
                                       save_checkpoint as jsave)

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.training import (jax_leaf_names,
                                             restore_jax_checkpoint)

F64 = dict(dtype=torch.float64, device="cpu")
M, K, D, N, S, LR = 6, 2, 1, 40, 4, 1e-2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """These CPU runs are many small ops: one intra-op thread keeps them
    from spinning against the other test workers' threads."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _data(seed=0, kind="smgp"):
    """X, Y (class labels for the MultiClass model), Z and Z_assign."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(-2, 2, (N, D))
    Y = np.sin(X) + 0.1 * rng.standard_normal((N, 1))
    if kind == "modified":
        Y = (Y > 0).astype(np.float64)
    Z = rng.uniform(-2, 2, (M, D))
    Za = rng.uniform(-2, 2, (M, D))
    return X, Y, Z, Za


def _jax_model(kind, Z, Za):
    pred = mgp.SVGP.create(JSE.create(0.5, 0.5), Z, num_latent_gps=K)
    if kind == "svgp":
        return pred
    assign = mgp.SVGP.create(JSE.create(0.1, 1.0), Za, num_latent_gps=K)
    if kind == "smgp":
        return mgp.SMGP(likelihood=JGaussian.create(0.5, D=K), pred_layer=pred,
                        assign_layer=assign, K=K, num_samples=S, num_data=N)
    return mgp.SMGPModified(likelihood=JMultiClass.create(K),
                            assign_likelihood=JGaussian.create(0.5, D=K),
                            pred_layer=pred, assign_layer=assign, K=K,
                            num_samples=S, num_data=N)


def _port_model(kind, Z, Za):
    pred = pt.SVGP.create(pt.SquaredExponential.create(0.5, 0.5, **F64), Z,
                          num_latent_gps=K, **F64)
    if kind == "svgp":
        return pred
    assign = pt.SVGP.create(pt.SquaredExponential.create(0.1, 1.0, **F64), Za,
                            num_latent_gps=K, **F64)
    if kind == "smgp":
        return pt.SMGP(pt.Gaussian.create(0.5, D=K, **F64), pred, assign, K=K,
                       num_samples=S, num_data=N)
    return pt.SMGPModified(pt.MultiClass.create(K), pred, assign,
                           assign_likelihood=pt.Gaussian.create(0.5, D=K, **F64),
                           K=K, num_samples=S, num_data=N)


def _leaves(tree):
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_leaves(model):
    return {n: p.detach().numpy().copy() for n, p in model.named_parameters()}


def _batches(X, Y):
    while True:
        yield jnp.asarray(X), jnp.asarray(Y)


def test_leaf_order_matches_jax_tree_flatten():
    X, Y, Z, Za = _data()
    for kind in ("smgp", "modified", "svgp"):
        want = list(_leaves(_jax_model(kind, Z, Za)))
        assert jax_leaf_names(_port_model(kind, Z, Za)) == want, kind
    Xv, Yv = X[:7], (Y[:7] > 0).astype(float)
    jvgp = mgp.VGP.create(JSE.create(1.0, 1.0), JBernoulli(), Xv, Yv)
    pvgp = pt.VGP.create(pt.SquaredExponential.create(1.0, 1.0, **F64),
                         pt.Bernoulli(), Xv, Yv, **F64)
    assert jax_leaf_names(pvgp) == list(_leaves(jvgp))


@pytest.mark.parametrize("kind", ["smgp", "modified", "svgp"])
def test_model_only_file_restores_bit_equal(kind, tmp_path):
    X, Y, Z, Za = _data(kind=kind)
    jmodel = _jax_model(kind, Z, Za)
    if kind != "svgp":   # move every leaf off its init
        jmodel, _, _ = jrun_adam(jmodel, 2, _batches(X, Y), LR,
                                 key=jax.random.PRNGKey(0), verbose=False,
                                 use_fused_adam=False)
    path = str(tmp_path / "model.npz")
    jsave(path, jmodel)
    model = _port_model(kind, Z, Za)
    assert restore_jax_checkpoint(path, model) == 0
    want = _leaves(jmodel)
    got = _port_leaves(model)
    assert list(got) == list(want)
    for name in want:
        assert np.array_equal(got[name], want[name]), name


def _noise(seed=3):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((S, N, K)), rng.gumbel(size=(S, N, K))


@pytest.mark.parametrize("kind", ["smgp", "modified"])
@pytest.mark.parametrize("fused", [False, True])
def test_train_state_restores_and_steps_like_jax(kind, fused, tmp_path):
    X, Y, Z, Za = _data(kind=kind)
    path = str(tmp_path / "state.npz")
    jrun_adam(_jax_model(kind, Z, Za), 3, _batches(X, Y), LR,
              key=jax.random.PRNGKey(7), verbose=False, checkpoint_path=path,
              checkpoint_every=3, use_fused_adam=fused)
    z, g = _noise()

    def jloss(m, key, Xb, Yb):
        e = m.E_log_p_Y_from_noise(Xb, Yb, jnp.asarray(z), jnp.asarray(g))
        kl = m.pred_layer.prior_kl() + m.assign_layer.prior_kl()
        return -(jnp.mean(e) - kl / m.num_data)

    init_fn, step_fn = jmake_train_step(optax.adam(LR), loss_fn=jloss)
    state = jrestore(path, init_fn(_jax_model(kind, Z, Za),
                                   jax.random.PRNGKey(0)))

    model = _port_model(kind, Z, Za)
    opt = pt.Adam(model, LR)
    gen = torch.Generator().manual_seed(123)
    assert restore_jax_checkpoint(path, model, opt, gen) == int(state.step) == 3
    assert opt.count == int(state.opt_state[0].count) == 3
    key = np.asarray(state.key).astype(np.uint64)
    assert gen.initial_seed() == int((key[0] << np.uint64(32)) | key[1])
    for name, leaf in _leaves(state.model).items():
        assert np.array_equal(dict(model.named_parameters())[name].detach(),
                              leaf), name
    bare = _port_model(kind, Z, Za)   # a TrainState read for its model alone
    assert restore_jax_checkpoint(path, bare) == 3
    assert all(np.array_equal(a, b) for a, b in
               zip(_port_leaves(bare).values(), _port_leaves(model).values()))
    mu, nu = _leaves(state.opt_state[0].mu), _leaves(state.opt_state[0].nu)
    for name, m, v in zip(opt.names, opt.m, opt.v):
        assert np.array_equal(m.numpy(), mu[name]), name
        assert np.array_equal(v.numpy(), nu[name]), name

    state, jl = step_fn(state, jnp.asarray(X), jnp.asarray(Y))
    zt, gt = torch.as_tensor(z), torch.as_tensor(g)

    def ploss(m, generator, Xb, Yb):
        e = m.E_log_p_Y_from_noise(Xb, Yb, zt, gt)
        kl = m.pred_layer.prior_kl() + m.assign_layer.prior_kl()
        return -(e.mean() - kl / m.num_data)

    pl = pt.make_train_step(opt, ploss)(model, gen, torch.as_tensor(X),
                                        torch.as_tensor(Y))
    np.testing.assert_allclose(float(pl), float(jl), rtol=1e-10)
    got = _port_leaves(model)
    for name, want in _leaves(state.model).items():
        np.testing.assert_allclose(got[name], want, rtol=1e-10, atol=1e-14,
                                   err_msg=name)


def test_files_that_do_not_fit_raise_and_change_nothing(tmp_path):
    X, Y, Z, Za = _data()
    jmodel = _jax_model("smgp", Z, Za)
    good = str(tmp_path / "smgp.npz")
    jsave(good, jmodel)
    arrays = dict(np.load(good))
    short = str(tmp_path / "short.npz")
    np.savez(short, **{k: v for k, v in arrays.items() if k != "leaf_10"})
    shape = str(tmp_path / "shape.npz")
    np.savez(shape, **{**arrays, "leaf_3": np.zeros((M + 1, K))})
    cases = [(good, _port_model("modified", Z, Za)),   # the wrong template
             (good, _port_model("svgp", Z, Za)),
             (short, _port_model("smgp", Z, Za)),      # a leaf count
             (shape, _port_model("smgp", Z, Za))]      # a shape
    for path, model in cases:
        with torch.no_grad():
            for p in model.parameters():
                p.add_(0.25)
        before = _port_leaves(model)
        with pytest.raises(ValueError):
            restore_jax_checkpoint(path, model)
        after = _port_leaves(model)
        assert all(np.array_equal(before[k], after[k]) for k in before)
    with pytest.raises(ValueError, match="model only"):
        restore_jax_checkpoint(good, _port_model("smgp", Z, Za),
                               torch.Generator())
