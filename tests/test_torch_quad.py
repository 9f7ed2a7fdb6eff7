"""The fused q_sqrt quadratic of modulatedgps_tpu_torch (ops/quad_kernel.py,
kernel #17) and the served variance that takes it, against the JAX package.

qsqrt_sq_colsum_plain is held against pallas_quad.qsqrt_sq_colsum in
interpret mode at M = 128 and 200 with a ragged N = 300 and a dirty upper
triangle in S (tests/test_pallas_quad.py's inputs): both multiply the same
bf16 operands exactly and sum in f32, so rtol 1e-5, atol 1e-5 of the
largest output.  The port's gradient (JAX's _quad_bwd formula) matches
JAX's custom VJP in f64 at 1e-10.  The served route in f32 on the CPU (the
kernel's plain version, bf16 operands) stays within chip_smoke's REF_TOL
of the f64 path at phase 4's size (M=1024, batch 2048); scaling the output
of #17, or the Cholesky factor, by 1.03 breaks those tolerances.
"""
import sys
from functools import lru_cache
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import pallas_quad

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import chip_smoke  # noqa: E402
import modulatedgps_tpu_torch as pt  # noqa: E402
from modulatedgps_tpu_torch.ops import chol_kernel, quad_kernel  # noqa: E402


def _inputs(K, M, N, seed=0):
    rng = np.random.default_rng(seed)
    S = (np.tril(rng.normal(size=(K, M, M))) * 0.1 + np.eye(M)
         + np.triu(rng.normal(size=(K, M, M)), 1) * 50.0)   # dirty upper
    A = rng.normal(size=(M, N)) / np.sqrt(M)
    return S.astype(np.float32), A.astype(np.float32)


@pytest.mark.parametrize("M", [128, 200])
def test_plain_matches_pallas_quad_interpret(M):
    S, A = _inputs(3, M, 300)
    want = np.asarray(pallas_quad.qsqrt_sq_colsum(jnp.asarray(S),
                                                  jnp.asarray(A), True))
    got = quad_kernel.qsqrt_sq_colsum_plain(torch.as_tensor(S),
                                            torch.as_tensor(A))
    assert got.shape == (3, 300) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    via = quad_kernel.qsqrt_sq_colsum(torch.as_tensor(S), torch.as_tensor(A))
    assert torch.equal(via, got)


def test_gradient_matches_jax_custom_vjp_f64():
    S, A = (x.astype(np.float64) for x in _inputs(2, 70, 45, seed=1))
    W = np.random.default_rng(2).normal(size=(2, 45))
    loss = lambda S, A: jnp.sum(pallas_quad.qsqrt_sq_colsum(S, A, True) * W)
    dS_j, dA_j = jax.grad(loss, argnums=(0, 1))(jnp.asarray(S), jnp.asarray(A))
    St, At = (torch.as_tensor(x).requires_grad_() for x in (S, A))
    (quad_kernel.qsqrt_sq_colsum(St, At) * torch.as_tensor(W)).sum().backward()
    for got, want in ((St.grad, dS_j), (At.grad, dA_j)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-10,
                                   atol=1e-10 * np.abs(want).max())
    assert not torch.triu(St.grad, 1).any()


# phase 4's size, where chip_smoke checks REF_TOL
M_SERVE, N_SERVE = chip_smoke.M_REF, chip_smoke.BATCH_REF


@lru_cache(maxsize=None)
def _served_inputs():
    arrays, rng = chip_smoke.smgp_arrays(M_SERVE)
    X = rng.uniform(-3, 3, size=(N_SERVE, chip_smoke.D_IN))
    Y = rng.normal(size=(N_SERVE, 1))
    return arrays, X, Y


@lru_cache(maxsize=None)
def _reference():
    return chip_smoke.reference_outputs(pt, *_served_inputs(), "cpu",
                                        torch.float64)


def _f32_outputs():
    return chip_smoke.reference_outputs(pt, *_served_inputs(), "cpu",
                                        torch.float32)


def _outside(got):
    """The (route, output) pairs of ``got`` outside REF_TOL of f64."""
    ref = _reference()
    out = []
    for route in ("served", "train"):
        for name, (rtol, atol_frac) in chip_smoke.REF_TOL.items():
            want = ref["train"][name]
            _, bad = chip_smoke.allclose_report(
                got[route][name], want, rtol, atol_frac * float(want.abs().max()))
            if bad:
                out.append((route, name))
    return out


def test_f32_served_route_is_within_ref_tol_of_f64():
    got = _f32_outputs()
    assert _outside(got) == []
    want = _reference()["served"]
    for name in chip_smoke.REF_TOL:   # the f64 served route is the train one
        np.testing.assert_allclose(want[name].numpy(),
                                   _reference()["train"][name].numpy(),
                                   rtol=1e-9, atol=1e-9 * float(want[name].abs().max()))


@pytest.mark.parametrize("fault", ["qsqrt_sq_colsum (#17)",
                                   "cholesky_factor (#15/#16)"])
def test_a_scaled_kernel_output_breaks_ref_tol(fault):
    if fault.startswith("qsqrt"):
        module, name = quad_kernel, "qsqrt_sq_colsum_plain"
        plain = quad_kernel.qsqrt_sq_colsum_plain
        scaled = lambda S, A: 1.03 * plain(S, A)  # noqa: E731
    else:
        module, name = chol_kernel, "cholesky_factor_plain"
        plain = chol_kernel.cholesky_factor_plain

        def scaled(K, block=64):
            L, Inv = plain(K, block)
            return 1.03 * L, Inv / 1.03
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(module, name, scaled)
        got = _f32_outputs()
    over = _outside(got)
    assert over, f"{fault} x1.03: every output within REF_TOL"
    if fault.startswith("qsqrt"):   # only the served route takes #17
        assert all(route == "served" for route, _ in over)
