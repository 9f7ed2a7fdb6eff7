"""The q_sqrt variance term of modulatedgps_tpu_torch against the JAX
Pallas kernel.

The port's atl_sq_colsum on CPU tensors runs the plain version of the tril
kernel: bf16(A^T tril L) with f32 accumulation, squared and summed.  It is
held against JAX atl_sq_colsum with every pallas_call patched to interpret
mode, at M=768 (BM 256, 3 block rows), N=300 (padded to the TPU's TN
inside JAX), K=2, with non-zero garbage above L's diagonal.  Tolerance:
rtol 2e-2 and atol 1e-2 * max, the bf16 bound of tests/test_pallas_tril.py:
both hold B in bf16, and a product that rounds to the other side of a bf16
step moves by ~0.4%.
"""
import contextlib
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import pallas_tril as ptl

from modulatedgps_tpu_torch.ops.tril_kernel import (atl_sq_colsum,
                                                    tril_sq_fwd,
                                                    tril_sq_fwd_plain)

K, M, N = 2, 768, 300


@contextlib.contextmanager
def _interpret():
    orig = ptl.pl.pallas_call

    def patched(*a, **kw):
        kw["interpret"] = True
        return orig(*a, **kw)

    with mock.patch.object(ptl.pl, "pallas_call", patched):
        yield


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    L = rng.normal(size=(K, M, M)).astype(np.float32)      # upper garbage
    A = (rng.normal(size=(M, N)) / np.sqrt(M)).astype(np.float32)
    return A, L


def test_sq_colsum_matches_pallas_interpret(data):
    A, L = data
    with _interpret():
        want = np.asarray(ptl.atl_sq_colsum(jnp.asarray(A), jnp.asarray(L)))
    got = atl_sq_colsum(torch.as_tensor(A), torch.as_tensor(L)).numpy()
    assert got.shape == (K, N) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=2e-2, atol=1e-2 * want.max())


def test_tril_fwd_reads_only_the_lower_triangle(data):
    A, L = data
    A16 = torch.as_tensor(A).to(torch.bfloat16)
    L16 = torch.as_tensor(L).to(torch.bfloat16)
    B16 = tril_sq_fwd(A16, L16)
    assert B16.dtype == torch.bfloat16 and B16.shape == (K, N, M)
    np.testing.assert_array_equal(
        B16.float().numpy(),
        tril_sq_fwd_plain(A16, torch.tril(L16)).float().numpy())


def test_tril_fwd_matches_f64_dense(data):
    """B16 is the f32-accumulated product rounded once to bf16: within one
    bf16 rounding (2^-8 relative) of the f64 product of the bf16 inputs."""
    A, L = data
    A16 = torch.as_tensor(A).to(torch.bfloat16)
    L16 = torch.as_tensor(L).to(torch.bfloat16)
    exact = A16.double().T.numpy() @ np.tril(L16.double().numpy())
    got = tril_sq_fwd(A16, L16).double().numpy()
    np.testing.assert_allclose(got, exact, rtol=2 ** -8,
                               atol=1e-5 * np.abs(exact).max())


def test_tril_fwd_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tril_sq_fwd(torch.zeros(4, 3, dtype=torch.bfloat16),
                    torch.zeros(2, 5, 5, dtype=torch.bfloat16))
