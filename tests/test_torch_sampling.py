"""Joint posterior sampling of modulatedgps_tpu_torch against the JAX
package: atl_matmul (kernel #5's plain version), predict_f(full_cov=True),
SVGP.predict_f_samples, SMGP.predict_samples and sample_W.

atl_matmul is held against pallas_tril.atl_matmul run in interpret mode at
K=3, M=1024, N=1000 (as tests/test_pallas_tril.py runs it): both multiply
the same bf16 operands exactly and sum in f32, in other orders, so they
agree to rtol and atol 1e-5 of the largest magnitude.  The f64 joint
posterior and the draws are held against JAX at rtol 1e-9 (atol 1e-9 of
each output's largest magnitude; the tolerance of tests/test_torch_train.py),
each package drawing from the same noise: the port's generator draws it
and JAX's draw is replaced by it.  The f32 tril route (bf16 operands) is
held against JAX's own bf16 route, forced onto the Pallas kernel in
interpret mode, at 1e-3 of the largest magnitude.
"""
import functools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.models import SMGP as JSMGP
from modulatedgps_tpu.models import SVGP as JSVGP
from modulatedgps_tpu.models import svgp as jsvgp_module
from modulatedgps_tpu.models.posterior import precompute_smgp as j_precompute
from modulatedgps_tpu.ops import conditionals as jc
from modulatedgps_tpu.ops import pallas_tril as ptl
from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE

import modulatedgps_tpu_torch as pt
from modulatedgps_tpu_torch.ops import conditionals as tc
from modulatedgps_tpu_torch.ops import tril_kernel

M, K, D, N, S = 48, 3, 2, 40, 4
RTOL = 1e-9


def _interp(fn):
    from jax.experimental import pallas as pl
    orig = pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    @functools.wraps(fn)
    def wrapper(*a, **kw):
        with mock.patch.object(ptl.pl, "pallas_call", patched):
            return fn(*a, **kw)
    return wrapper


def _close(got, want, rtol=RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * np.abs(want).max())


def test_atl_matmul_plain_matches_pallas_interpret():
    rng = np.random.default_rng(0)
    L = rng.normal(size=(3, 1024, 1024)).astype(np.float32)   # upper garbage
    A = (rng.normal(size=(1024, 1000)) / np.sqrt(1024)).astype(np.float32)
    want = _interp(lambda: ptl.atl_matmul(jnp.asarray(A), jnp.asarray(L)))()
    got = tril_kernel.atl_matmul(torch.as_tensor(A), torch.as_tensor(L))
    assert got.dtype == torch.float32
    _close(got.numpy(), want, rtol=1e-5)


def test_atl_matmul_refuses_autograd_and_runs_without_it():
    """atl_matmul no longer refuses autograd: with it, the forward is #5's
    plain version and the backward #6/#7's on W16 = bf16(dB); without it,
    the same forward."""
    A = torch.randn(6, 5, requires_grad=True)
    L = torch.randn(2, 6, 6, requires_grad=True)
    B = tril_kernel.atl_matmul(A, L)
    want = tril_kernel.tril_fwd_f32_plain(A.detach().bfloat16(),
                                          L.detach().bfloat16())
    assert torch.equal(B.detach(), want)
    Bbar = torch.randn(2, 5, 6)
    B.backward(Bbar)
    W16 = Bbar.bfloat16()
    assert torch.equal(A.grad, tril_kernel.tril_da_plain(L.detach().bfloat16(),
                                                         W16))
    assert torch.equal(L.grad, tril_kernel.tril_dl_plain(A.detach().bfloat16(),
                                                         W16))
    with torch.no_grad():
        assert torch.equal(tril_kernel.atl_matmul(A, L), want)


def _perturbed_layer(rng, variance, lengthscale, q_diag=False):
    layer = JSVGP.create(JSE.create(variance, lengthscale),
                         rng.normal(size=(M, D)), num_latent_gps=K,
                         q_diag=q_diag)
    q_mu = 0.5 * rng.normal(size=(M, K))
    if q_diag:
        q_sqrt = np.log(np.expm1(rng.uniform(0.3, 1.2, size=(M, K))))
    else:
        q_sqrt = np.eye(M)[None] + 0.05 * np.tril(rng.normal(size=(K, M, M)))
        q_sqrt[:, np.arange(M), np.arange(M)] = np.abs(
            q_sqrt[:, np.arange(M), np.arange(M)])
    return layer.replace(q_mu=layer.q_mu.replace_raw(jnp.asarray(q_mu)),
                         q_sqrt=layer.q_sqrt.replace_raw(jnp.asarray(q_sqrt)))


def _leaves(model):
    leaves = jax.tree_util.tree_flatten_with_path(model)[0]
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf) for path, leaf in leaves}


def _models(q_diag=False, dtype=torch.float64, jitter=None):
    rng = np.random.default_rng(1)
    jm = JSMGP(likelihood=JGaussian.create(0.5, D=K),
               pred_layer=_perturbed_layer(rng, 0.5, 0.5, q_diag),
               assign_layer=_perturbed_layer(rng, 0.1, 1.0, q_diag),
               K=K, num_samples=S, num_data=100)
    tm = pt.smgp_from_numpy(_leaves(jm), K=K, num_samples=S, num_data=100,
                            temperature=1e-2, device="cpu", dtype=dtype,
                            jitter=jitter)
    X = rng.uniform(-3, 3, size=(N, D))
    return jm, tm, X


@pytest.mark.parametrize("form", ["tril", "diag"])
@pytest.mark.parametrize("full_output_cov", [False, True])
def test_predict_f_full_cov_matches_jax_f64(form, full_output_cov):
    jm, tm, X = _models(q_diag=form == "diag")
    for layer in ("pred_layer", "assign_layer"):
        mj, vj = getattr(jm, layer).predict_f(
            jnp.asarray(X), full_cov=True, full_output_cov=full_output_cov)
        with torch.no_grad():
            mt, vt = getattr(tm, layer).predict_f(
                torch.as_tensor(X), full_cov=True,
                full_output_cov=full_output_cov)
        _close(mt.numpy(), mj)
        _close(vt.numpy(), vj)


def test_base_conditional_full_cov_without_q_sqrt_matches_jax():
    rng = np.random.default_rng(2)
    Z, X = rng.normal(size=(20, 2)), rng.normal(size=(15, 2))
    jk = JSE.create(0.7, 0.9)
    Kmm = np.asarray(jk.K(jnp.asarray(Z))) + 1e-6 * np.eye(20)
    Kmn = np.asarray(jk.K(jnp.asarray(Z), jnp.asarray(X)))
    Knn = np.asarray(jk.K(jnp.asarray(X)))
    q_mu = rng.normal(size=(20, K))
    mj, vj = jc.base_conditional(jnp.asarray(Kmn), jnp.asarray(Kmm),
                                 jnp.asarray(Knn), jnp.asarray(q_mu),
                                 full_cov=True)
    t = torch.tensor
    mt, vt = tc.base_conditional(t(Kmn), t(Kmm), t(Knn), t(q_mu),
                                 full_cov=True)
    assert vt.shape == (K, 15, 15)
    _close(mt.numpy(), mj)
    _close(vt.numpy(), vj)


def test_f32_joint_covariance_matches_jax_bf16_route():
    """The f32 tril route (atl_matmul: bf16 operands, f32 B) against JAX's
    conditional forced onto its tril Pallas kernel (interpret mode; BM=16
    so that M=48 has several tril blocks), both at f32's jitter 1e-4.  The two form A differently in f32 before rounding it to
    bf16, which moves the covariance by ~1e-4 of its largest entry."""
    jm, tm, X = _models(dtype=torch.float32, jitter=1e-4)
    jm32 = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a, jnp.float32) if hasattr(a, "dtype") else a, jm)
    try:
        ptl.set_tril_dispatch(True)
        with mock.patch.object(ptl, "eligible", lambda M_, min_M=2048: True), \
                mock.patch("modulatedgps_tpu.ops.pallas_tril._block_m",
                           lambda M_: 16), \
                mock.patch.object(ptl, "_fwd_pallas",
                                  wraps=ptl._fwd_pallas) as fwd:
            mj, vj = _interp(lambda: jm32.pred_layer.predict_f(
                jnp.asarray(X, jnp.float32), full_cov=True))()
        assert fwd.call_count == 1
    finally:
        ptl.set_tril_dispatch(None)
    with torch.no_grad():
        mt, vt = tm.pred_layer.predict_f(torch.as_tensor(X, dtype=torch.float32),
                                         full_cov=True)
    _close(mt.numpy(), mj, rtol=1e-3)
    _close(vt.numpy(), vj, rtol=1e-3)


@pytest.mark.parametrize("full_cov", [True, False])
def test_predict_f_samples_matches_jax_with_the_same_z(full_cov):
    jm, tm, X = _models()
    with torch.no_grad():
        got = tm.pred_layer.predict_f_samples(torch.Generator().manual_seed(3),
                                              torch.as_tensor(X), S,
                                              full_cov=full_cov)
    shape = (S, K, N, 1) if full_cov else (S, N, K)
    z = torch.randn(shape, generator=torch.Generator().manual_seed(3),
                    dtype=torch.float64)
    with mock.patch.object(jsvgp_module.jax.random, "normal",
                           lambda key, shape_, dtype: jnp.asarray(z.numpy())):
        want = jm.pred_layer.predict_f_samples(jax.random.PRNGKey(0),
                                               jnp.asarray(X), S,
                                               full_cov=full_cov)
    assert got.shape == (S, N, K)
    _close(got.numpy(), want)


@pytest.mark.parametrize("route", ["train", "served"])
def test_predict_samples_and_sample_W_match_jax(route):
    """Both on a trained model and on precompute_smgp's serving model, as
    tests/test_models.py requires of JAX; the port's noise fed to JAX."""
    jm, tm, X = _models()
    if route == "served":
        jm, tm = j_precompute(jm), pt.precompute_smgp(tm)
    Xt = torch.as_tensor(X)
    with torch.no_grad():
        ys, fs = tm.predict_samples(torch.Generator().manual_seed(4), Xt, S)
        W = tm.sample_W(torch.Generator().manual_seed(5), Xt, S)
    gen = torch.Generator().manual_seed(4)
    noise = tm.draw_noise(gen, N, S, torch.float64)
    z = torch.randn((S, N, K), generator=gen, dtype=torch.float64)
    as_jax = lambda *ts: tuple(jnp.asarray(t.numpy()) for t in ts)
    with mock.patch.object(JSMGP, "draw_noise",
                           lambda self, key, n, s, dtype: as_jax(*noise)), \
            mock.patch.object(jax.random, "normal",
                              lambda key, shape, dtype: as_jax(z)[0]):
        ys_j, fs_j = jm.predict_samples(jax.random.PRNGKey(0), jnp.asarray(X),
                                        S)
    noise_w = tm.draw_noise(torch.Generator().manual_seed(5), N, S,
                            torch.float64)
    with mock.patch.object(JSMGP, "draw_noise",
                           lambda self, key, n, s, dtype: as_jax(*noise_w)):
        W_j = jm.sample_W(jax.random.PRNGKey(0), jnp.asarray(X), S)
    assert ys.shape == fs.shape == (S, N, 1) and W.shape == (S, N, K)
    for got, want in ((ys, ys_j), (fs, fs_j), (W, W_j)):
        _close(got.numpy(), want)


def test_chip_smoke_sampling_phases_run_on_cpu():
    """chip_smoke's sampling phase at a tiny size on CPU tensors: every
    check passes but the launch counts, which stay 0 off the card; the
    resume and multi-start phases pass whole."""
    import chip_smoke
    chip_smoke.failures.clear()
    try:
        counts = chip_smoke.phase_sampling(pt, dev="cpu", M=32, N=24, S=3)
        assert set(counts) == set(chip_smoke.SAMPLING_KERNELS)
        assert not any(counts.values())
        assert len(chip_smoke.failures) == len(counts)
        assert all("launched 0 times" in f for f in chip_smoke.failures)
        chip_smoke.failures.clear()
        chip_smoke.phase_resume(pt, dev="cpu", M=32, batch=64)
        chip_smoke.phase_multistart(pt, dev="cpu", M=32, batch=64)
        assert chip_smoke.failures == []
    finally:
        chip_smoke.failures.clear()


@pytest.mark.parametrize("scale", [1.0, 1.03])
def test_sample_tol_tells_f32_rounding_from_a_faulty_tril_forward(scale):
    """chip_smoke's SAMPLE_TOL: the port's f32 CPU path (kernel #5's plain
    version) lies within it on every output at M=1024, N=512; scaling #5's
    output by 1.03 moves both covariances past it."""
    import chip_smoke
    arrays, rng = chip_smoke.smgp_arrays(chip_smoke.M_REF)
    X = rng.uniform(-3, 3, size=(chip_smoke.N_GRID_REF, chip_smoke.D_IN))
    want = chip_smoke.joint_posterior(pt, arrays, X, "cpu", torch.float64)
    plain = tril_kernel.tril_fwd_f32_plain
    with mock.patch.object(tril_kernel, "tril_fwd_f32_plain",
                           lambda A16, L16: scale * plain(A16, L16)):
        got = chip_smoke.joint_posterior(pt, arrays, X, "cpu", torch.float32)
    within = {name: float((got[name] - want[name]).abs().max()
                          / want[name].abs().max()) <= tol
              for name, tol in chip_smoke.SAMPLE_TOL.items()}
    if scale == 1.0:
        assert all(within.values()), within
    else:
        assert not within["pred_layer.cov"] and not within["assign_layer.cov"]


def test_chip_smoke_exits_nonzero_without_a_card(tmp_path):
    """Without CUDA, and alone in a directory without the package, the
    script fails before printing a result."""
    import shutil
    import subprocess
    import sys
    from pathlib import Path
    src = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    shutil.copy(src, tmp_path / "chip_smoke.py")
    for cwd in (src.parent, tmp_path):
        res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                             capture_output=True, text=True, timeout=120,
                             env={"PATH": "/usr/bin:/bin",
                                  "CUDA_VISIBLE_DEVICES": ""})
        assert res.returncode != 0
        assert '"ok": true' not in res.stdout
