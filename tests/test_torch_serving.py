"""The serving slice of modulatedgps_tpu_torch against the JAX package, f64.

One SMGP (M=64, K=3, D=2) at a perturbed state is built in JAX and carried
into the port through smgp_from_numpy; both serve the same N=50 inputs
through the training-path conditional (SVGP.predict_f) and the precomputed
posterior (precompute_smgp).  At the whitened init the q_sqrt term cancels
exactly, so the state is perturbed: q_mu ~ 0.5 N(0, 1) and
q_sqrt = I + 0.05 tril(N(0, 1)) with a positive diagonal.

Tolerance: rtol 1e-9 in float64.  The two packages compute the same
quantities and differ only in summation order (JAX's CPU conditional
solves by substitution where the port multiplies by L^-1, and the port's
served variance takes |S^T a|^2 - |a|^2 where JAX forms k^T Q k; see
modulatedgps_tpu_torch/models/posterior.py).  In f64 at cond(Kmm) <~ 1e7
(jitter 1e-6) that moves results by well under 1e-9 of their scale; atol
is 1e-9 of each output's largest magnitude, for entries that cancel to
near zero.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.likelihoods import Gaussian as JGaussian
from modulatedgps_tpu.models import SMGP as JSMGP
from modulatedgps_tpu.models import SVGP as JSVGP
from modulatedgps_tpu.models.posterior import precompute_smgp as j_precompute
from modulatedgps_tpu.ops.kernels import SquaredExponential as JSE

import modulatedgps_tpu_torch as pt

M, K, D, N = 64, 3, 2, 50
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


def _raw_arrays(model):
    leaves = jax.tree_util.tree_flatten_with_path(model)[0]
    return {jax.tree_util.keystr(path, simple=True, separator="."):
            np.asarray(leaf) for path, leaf in leaves}


@pytest.fixture(scope="module")
def outputs():
    rng = np.random.default_rng(0)
    jm = JSMGP(likelihood=JGaussian.create(0.5, D=K),
               pred_layer=_perturbed_layer(rng, 0.5, 0.5),
               assign_layer=_perturbed_layer(rng, 0.1, 1.0),
               K=K, num_samples=4, num_data=100)
    X = rng.uniform(-3, 3, size=(N, D))
    Y = rng.normal(size=(N, 1))
    tm = pt.smgp_from_numpy(_raw_arrays(jm), K=K, num_samples=4, num_data=100,
                            temperature=1e-2, device="cpu",
                            dtype=torch.float64)
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    Xt, Yt = torch.as_tensor(X), torch.as_tensor(Y)
    out = {}
    pt.reset_launch_counts()
    with torch.inference_mode():
        for name in ("pred_layer", "assign_layer"):
            fj = getattr(jm, name).predict_f(Xj)
            ft = getattr(tm, name).predict_f(Xt)
            out[f"{name}.predict_f.mean"] = (ft[0], fj[0])
            out[f"{name}.predict_f.var"] = (ft[1], fj[1])
        served_t, served_j = pt.precompute_smgp(tm), j_precompute(jm)
        for route, mt, mj in (("train", tm, jm), ("served", served_t, served_j)):
            yt, yj = mt.predict_y(Xt, S=2), mj.predict_y(Xj, S=2)
            out[f"{route}.predict_y.mean"] = (yt[0], yj[0])
            out[f"{route}.predict_y.var"] = (yt[1], yj[1])
            out[f"{route}.predict_assign"] = (mt.predict_assign(Xt),
                                              mj.predict_assign(Xj))
            out[f"{route}.predict_density"] = (mt.predict_density(Xt, Yt),
                                               mj.predict_density(Xj, Yj))
    out = {k: (np.asarray(a), np.asarray(b)) for k, (a, b) in out.items()}
    return out, pt.launch_counts()


CASES = [f"{layer}.predict_f.{m}" for layer in ("pred_layer", "assign_layer")
         for m in ("mean", "var")] + [
    f"{route}.{what}" for route in ("train", "served")
    for what in ("predict_y.mean", "predict_y.var", "predict_assign",
                 "predict_density")]


@pytest.mark.parametrize("case", CASES)
def test_slice_matches_jax_f64(outputs, case):
    got, want = outputs[0][case]
    assert got.shape == want.shape and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL,
                               atol=RTOL * np.abs(want).max())


def test_cpu_run_launches_no_kernel(outputs):
    assert set(outputs[1]) >= {"kxz", "trsm_lower", "tril_sq_fwd"}
    assert not any(outputs[1].values())


def test_serving_invariants(outputs):
    out = outputs[0]
    pi = out["served.predict_assign"][0]
    np.testing.assert_allclose(pi.sum(-1), 1.0, rtol=1e-12)
    assert np.all(out["served.predict_y.var"][0] > 0)
    assert np.all(out["pred_layer.predict_f.var"][0] > 0)


@pytest.mark.parametrize("q_diag", [False, True])
def test_svgp_create_and_kuu_match_jax(q_diag):
    """A fresh layer (gpflow init: q_mu = 0, q_sqrt = I or ones) and its
    Kuu = K(Z, Z) + 1e-6 I at f64."""
    rng = np.random.default_rng(2)
    Z = rng.normal(size=(M, D))
    jl = JSVGP.create(JSE.create(0.5, 0.5), Z, num_latent_gps=K, q_diag=q_diag)
    tl = pt.SVGP.create(pt.SquaredExponential.create(0.5, 0.5,
                                                     dtype=torch.float64,
                                                     device="cpu"),
                        Z, K, q_diag=q_diag, dtype=torch.float64, device="cpu")
    for name in ("Z", "q_mu", "q_sqrt"):
        np.testing.assert_allclose(getattr(tl, name).value.detach().numpy(),
                                   np.asarray(getattr(jl, name).value),
                                   rtol=1e-15, atol=0)
    with torch.inference_mode():
        np.testing.assert_allclose(tl.kuu().numpy(), np.asarray(jl.kuu()),
                                   rtol=1e-12, atol=1e-15)


def test_smgp_from_numpy_carries_raw_leaves():
    rng = np.random.default_rng(1)
    jm = JSMGP(likelihood=JGaussian.create(0.7, D=K),
               pred_layer=_perturbed_layer(rng, 0.5, 0.5),
               assign_layer=_perturbed_layer(rng, 0.1, 1.0),
               K=K, num_samples=4, num_data=100)
    raw = _raw_arrays(jm)
    tm = pt.smgp_from_numpy(raw, K=K, num_samples=4, num_data=100,
                            temperature=1e-2, device="cpu",
                            dtype=torch.float64)
    ported = {name: p.detach().numpy() for name, p in tm.named_parameters()}
    assert set(ported) == set(raw)
    for name, value in raw.items():
        np.testing.assert_array_equal(ported[name], value)
    assert tm.pred_layer.q_sqrt.transform == "tril"
    np.testing.assert_allclose(tm.likelihood.variance.value.detach().numpy(),
                               np.full((1, K), 0.7), rtol=1e-12)


def test_chip_smoke_model_has_the_jax_pytree_layout():
    """chip_smoke.py builds its model from raw leaves it makes itself; they
    must be exactly the JAX SMGP's leaves (same keys, same shapes)."""
    import chip_smoke
    arrays, _ = chip_smoke.smgp_arrays(16)
    jm = JSMGP(likelihood=JGaussian.create(0.5, D=chip_smoke.K_EXPERTS),
               pred_layer=JSVGP.create(JSE.create(0.5, 0.5),
                                       np.zeros((16, chip_smoke.D_IN)),
                                       num_latent_gps=chip_smoke.K_EXPERTS),
               assign_layer=JSVGP.create(JSE.create(0.1, 1.0),
                                         np.zeros((16, chip_smoke.D_IN)),
                                         num_latent_gps=chip_smoke.K_EXPERTS),
               K=chip_smoke.K_EXPERTS)
    want = {k: v.shape for k, v in _raw_arrays(jm).items()}
    assert {k: np.shape(v) for k, v in arrays.items()} == want
    np.testing.assert_allclose(np.asarray(arrays["likelihood.variance.raw"]),
                               _raw_arrays(jm)["likelihood.variance.raw"],
                               rtol=1e-12)


def test_chip_smoke_slice_phase_runs_on_cpu():
    """chip_smoke's serving phase at a tiny size on CPU tensors: every
    check passes except the launch counts, which stay 0 off the card."""
    import chip_smoke
    chip_smoke.failures.clear()
    try:
        counts = chip_smoke.phase_slice(pt, dev="cpu", M=64, batch=128)
        assert counts == {"kxz": 0, "trsm_lower": 0, "tril_sq_fwd": 0}
        assert len(chip_smoke.failures) == 3
        assert all("launched 0 times" in f for f in chip_smoke.failures)
    finally:
        chip_smoke.failures.clear()
