"""Checkpoint, resume and multi-start of modulatedgps_tpu_torch
(training/checkpoint.py, training/loop.py), mirroring
tests/test_training_infra.py of the JAX package.

A checkpoint round trip is bit-exact; a run interrupted, saved and resumed
into a freshly built model ends bit for bit where an uninterrupted run
does, and within 1e-9 (f64, the tolerance of tests/test_torch_train.py)
of the JAX package's uninterrupted run with the same fixed noise.  The
final checkpoint holds the state returned; a completed run resumes as a
no-op.  run_adam_multistart's continuation is bit for bit a single
uninterrupted run of the winning replica.
"""
import warnings

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
from modulatedgps_tpu.training import loop as jloop

import modulatedgps_tpu_torch as pt

M, K, D, N, S = 16, 2, 2, 30, 3
NUM_DATA, LR = 100, 1e-2


def _arrays(seed=0):
    """A small SMGP at a perturbed state (as tests/test_torch_train.py: at
    the whitened init some gradients cancel to rounding, which Adam's
    normalised step would amplify past 1e-9)."""
    rng = np.random.default_rng(seed)

    def layer():
        svgp = JSVGP.create(JSE.create(0.5, 0.5), rng.normal(size=(M, D)),
                            num_latent_gps=K)
        q_sqrt = np.eye(M)[None] + 0.05 * np.tril(rng.normal(size=(K, M, M)))
        q_sqrt[:, np.arange(M), np.arange(M)] = np.abs(
            q_sqrt[:, np.arange(M), np.arange(M)])
        return svgp.replace(
            q_mu=svgp.q_mu.replace_raw(jnp.asarray(
                0.5 * rng.normal(size=(M, K)))),
            q_sqrt=svgp.q_sqrt.replace_raw(jnp.asarray(q_sqrt)))
    jm = JSMGP(likelihood=JGaussian.create(0.5, D=K), pred_layer=layer(),
               assign_layer=layer(), K=K, num_samples=S, num_data=NUM_DATA)
    leaves = jax.tree_util.tree_flatten_with_path(jm)[0]
    arrays = {jax.tree_util.keystr(p, simple=True, separator="."):
              np.asarray(v) for p, v in leaves}
    X = rng.uniform(-3, 3, size=(N, D))
    Y = rng.normal(size=(N, 1))
    return jm, arrays, X, Y, rng


def _model(arrays, dtype=torch.float64):
    return pt.smgp_from_numpy(arrays, K=K, num_samples=S, num_data=NUM_DATA,
                              temperature=1e-2, device="cpu", dtype=dtype)


def _batches(X, Y, dtype=torch.float64):
    Xt, Yt = torch.as_tensor(X, dtype=dtype), torch.as_tensor(Y, dtype=dtype)
    return iter(lambda: (Xt, Yt), None)


def _assert_same(a, b):
    pa, pb = dict(a.named_parameters()), dict(b.named_parameters())
    assert sorted(pa) == sorted(pb)
    for k in pa:
        assert torch.equal(pa[k], pb[k]), k


def test_checkpoint_roundtrip_is_bit_exact(tmp_path):
    _, arrays, X, Y, _ = _arrays()
    model = _model(arrays, torch.float32)
    gen = torch.Generator().manual_seed(3)
    opt = pt.Adam(model, LR)
    step = pt.make_train_step(opt)
    batch = next(_batches(X, Y, torch.float32))
    step(model, gen, *batch)
    path = str(tmp_path / "ck.npz")
    pt.save_checkpoint(path, model, opt, 1, gen)
    model2 = _model(arrays, torch.float32)
    opt2, gen2 = pt.Adam(model2, LR), torch.Generator().manual_seed(99)
    assert pt.restore_checkpoint(path, model2, opt2, gen2) == 1
    _assert_same(model2, model)
    assert opt2.count == opt.count == 1
    for x, y in zip(opt.m + opt.v, opt2.m + opt2.v):
        assert torch.equal(x, y)
    assert torch.equal(gen.get_state(), gen2.get_state())
    l1 = step(model, gen, *batch)
    l2 = pt.make_train_step(opt2)(model2, gen2, *batch)
    assert torch.equal(l1, l2)
    _assert_same(model2, model)


def test_restore_into_the_wrong_template_raises(tmp_path):
    _, arrays, _, _, _ = _arrays()
    model = _model(arrays)
    gen = torch.Generator()
    path = str(tmp_path / "ck.npz")
    pt.save_checkpoint(path, model, pt.Adam(model, LR), 0, gen)
    _, other, _, _, _ = _arrays(seed=1)
    other = {k: (np.zeros((M + 1,) + v.shape[1:]) if k.endswith("Z.raw")
                 else v) for k, v in other.items()}
    bigger = _model(other)
    with pytest.raises(ValueError, match="shape"):
        pt.restore_checkpoint(path, bigger, pt.Adam(bigger, LR), gen)
    frozen = _model(arrays)
    frozen.pred_layer.Z.raw.requires_grad_(False)
    with pytest.raises(ValueError, match="does not fit"):
        pt.restore_checkpoint(path, frozen, pt.Adam(frozen, LR), gen)


def test_checkpoint_resume_after_interrupt_matches_jax(tmp_path):
    """JAX: 6 uninterrupted steps with fixed noise.  Port: 3 steps, save,
    restore into a fresh model, 3 more; equal to JAX at 1e-9 and bit for
    bit to the port's own uninterrupted 6."""
    jm, arrays, X, Y, rng = _arrays()
    z, g = rng.normal(size=(S, N, K)), rng.gumbel(size=(S, N, K))
    zj, gj, zt, gt = jnp.asarray(z), jnp.asarray(g), torch.tensor(z), \
        torch.tensor(g)

    def jloss(model, key, X, Y):
        kl = model.pred_layer.prior_kl() + model.assign_layer.prior_kl()
        return -(jnp.mean(model.E_log_p_Y_from_noise(X, Y, zj, gj))
                 - kl / model.num_data)

    def tloss(model, generator, X, Y):
        kl = model.pred_layer.prior_kl() + model.assign_layer.prior_kl()
        return -(model.E_log_p_Y_from_noise(X, Y, zt, gt).mean()
                 - kl / model.num_data)

    init_fn, step_fn = jloop.make_train_step(optax.adam(LR), loss_fn=jloss)
    state = init_fn(jm, jax.random.PRNGKey(0))
    for _ in range(6):
        state, _ = step_fn(state, jnp.asarray(X), jnp.asarray(Y))

    def port_run(model, opt, steps):
        step = pt.make_train_step(opt, loss_fn=tloss)
        batches = _batches(X, Y)
        for _ in range(steps):
            step(model, None, *next(batches))

    full = _model(arrays)
    port_run(full, pt.Adam(full, LR), 6)
    first = _model(arrays)
    opt = pt.Adam(first, LR)
    port_run(first, opt, 3)
    path = str(tmp_path / "mid.npz")
    pt.save_checkpoint(path, first, opt, 3, torch.Generator())
    resumed = _model(arrays)
    opt2 = pt.Adam(resumed, LR)
    assert pt.restore_checkpoint(path, resumed, opt2, torch.Generator()) == 3
    port_run(resumed, opt2, 3)
    _assert_same(resumed, full)
    want = jax.tree_util.tree_flatten_with_path(state.model)[0]
    got = pt.smgp_to_numpy(resumed)
    for path_, leaf in want:
        key = jax.tree_util.keystr(path_, simple=True, separator=".")
        leaf = np.asarray(leaf)
        np.testing.assert_allclose(got[key], leaf, rtol=1e-9,
                                   atol=1e-9 * np.abs(leaf).max(), err_msg=key)


def test_run_adam_periodic_checkpoint_and_resume(tmp_path):
    _, arrays, X, Y, _ = _arrays()
    path = str(tmp_path / "state.npz")
    full, _, _ = pt.run_adam(_model(arrays), 6, _batches(X, Y), LR,
                             verbose=False)
    pt.run_adam(_model(arrays), 3, _batches(X, Y), LR, verbose=False,
                checkpoint_path=path, checkpoint_every=3)
    resumed, iters, _ = pt.run_adam(_model(arrays), 6, _batches(X, Y), LR,
                                    log_every=1, verbose=False,
                                    checkpoint_path=path, checkpoint_every=3,
                                    resume=True)
    assert iters == [4, 5, 6]   # continued, not restarted
    _assert_same(resumed, full)


def test_run_adam_final_checkpoint_not_stale(tmp_path, capsys):
    _, arrays, X, Y, _ = _arrays()
    path = str(tmp_path / "state.npz")
    m7, _, _ = pt.run_adam(_model(arrays), 7, _batches(X, Y), LR,
                           verbose=False, checkpoint_path=path,
                           checkpoint_every=3)
    saved = _model(arrays)
    opt = pt.Adam(saved, LR)
    assert pt.restore_checkpoint(path, saved, opt, torch.Generator()) == 7
    assert opt.count == 7
    _assert_same(saved, m7)
    again, iters, elbos = pt.run_adam(_model(arrays), 7, _batches(X, Y), LR,
                                      checkpoint_path=path,
                                      checkpoint_every=3, resume=True)
    assert iters == [] and elbos == []
    assert "training already complete" in capsys.readouterr().out
    _assert_same(again, m7)


def test_run_adam_warns_checkpoint_every_without_path():
    _, arrays, X, Y, _ = _arrays()
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        pt.run_adam(_model(arrays), 2, _batches(X, Y), LR, verbose=False,
                    checkpoint_every=5)
    assert any("checkpoint_every" in str(x.message) for x in w)


def test_run_adam_multistart_selects_and_continues():
    """The winner's continuation equals a single uninterrupted run of that
    replica: same seed, same iterator stream, Adam state carried over."""
    _, arrays, X, Y, _ = _arrays()

    def make_iter(s):
        r = np.random.default_rng(10 + s)
        idx = r.permutation(N)[:20]
        return _batches(X[idx], Y[idx])

    model = _model(arrays)
    before = {k: p.clone() for k, p in model.named_parameters()}
    won, iters, elbos, info = pt.run_adam_multistart(
        model, 12, make_iter, LR, num_starts=3, probe_iters=5,
        probe_data=next(_batches(X, Y)), eval_keys=2, seed=7, log_every=3,
        verbose=False)
    assert info["num_starts"] == 3 and 0 <= info["winner"] < 3
    assert len(info["probe_scores"]) == 3 and info["probe_iters"] == 5
    assert info["probe_scores"][info["winner"]] == max(info["probe_scores"])
    assert iters == [6, 9, 12] and np.isfinite(elbos).all()
    for k, p in model.named_parameters():
        assert torch.equal(p, before[k])            # the input is untouched
    w = info["winner"]
    ref, _, _ = pt.run_adam(_model(arrays), 12, make_iter(w), LR,
                            generator=torch.Generator().manual_seed(7 + w),
                            verbose=False)
    _assert_same(won, ref)


def test_run_adam_multistart_defaults_match_jax():
    import inspect
    want = inspect.signature(jloop.run_adam_multistart).parameters
    got = inspect.signature(pt.run_adam_multistart).parameters
    for name in ("num_starts", "probe_iters", "eval_keys", "log_every",
                 "probe_data"):
        assert got[name].default == want[name].default, name
