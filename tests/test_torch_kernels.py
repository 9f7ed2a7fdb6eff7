"""K(X, X2) of modulatedgps_tpu_torch against the JAX package.

The port's kxz wrapper on CPU tensors runs its plain version; it is held
against the JAX Pallas kernel run in interpret mode, in f32 (N=300, M=200,
D=3, scalar and ARD lengthscales).  Tolerance: rtol 1e-5 with atol
1e-6 * variance — both evaluate |x|^2 + |z|^2 - 2 x.z in f32, whose
cancellation moves d2 by a few f32 ulps, and the exp tail near 0 needs the
absolute floor.  The kernel classes are held against JAX's at f64 (rtol
1e-12: the same formula, summation order aside).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import kernels as jk
from modulatedgps_tpu.ops.pallas_kernels import matern32_kxz, rbf_kxz

from modulatedgps_tpu_torch.ops import kernels as tk
from modulatedgps_tpu_torch.ops.kxz_kernel import kxz

N, M, D = 300, 200, 3
VARIANCE = 0.7


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
@pytest.mark.parametrize("ard", [False, True])
def test_kxz_plain_matches_pallas_interpret(kind, ard):
    rng = np.random.default_rng(0)
    X = rng.uniform(-3, 3, size=(N, D)).astype(np.float32)
    Z = rng.normal(size=(M, D)).astype(np.float32)
    ls = (np.asarray([0.5, 0.8, 1.3], np.float32) if ard
          else np.asarray(0.5, np.float32))
    var = np.asarray(VARIANCE, np.float32)
    fn = rbf_kxz if kind == "rbf" else matern32_kxz
    want = np.asarray(fn(jnp.asarray(X), jnp.asarray(Z), jnp.asarray(var),
                         jnp.asarray(ls), True))
    got = kxz(torch.as_tensor(X), torch.as_tensor(Z), torch.as_tensor(ls),
              torch.as_tensor(var), kind=kind).numpy()
    assert got.dtype == np.float32 and got.shape == (N, M)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * VARIANCE)


@pytest.mark.parametrize("name", ["SquaredExponential", "Matern32"])
def test_kernel_classes_match_jax_f64(name):
    rng = np.random.default_rng(1)
    X = rng.normal(size=(40, 2))
    Z = rng.normal(size=(25, 2))
    jkern = getattr(jk, name).create(0.8, [0.6, 1.1])
    tkern = getattr(tk, name).create(0.8, [0.6, 1.1], dtype=torch.float64,
                                     device="cpu")
    Xt, Zt = torch.as_tensor(X), torch.as_tensor(Z)
    with torch.inference_mode():
        pairs = [(tkern.K(Xt, Zt), jkern.K(jnp.asarray(X), jnp.asarray(Z))),
                 (tkern(Xt), jkern(jnp.asarray(X))),
                 (tkern(Xt, full_cov=False), jkern(jnp.asarray(X),
                                                   full_cov=False))]
    for got, want in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-14)


def test_kernel_full_cov_false_rejects_x2():
    kern = tk.SquaredExponential.create(dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError):
        kern(torch.zeros(3, 2, dtype=torch.float64),
             torch.zeros(4, 2, dtype=torch.float64), full_cov=False)
