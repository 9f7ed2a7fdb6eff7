"""The TRSM's wavefront walk (modulatedgps_tpu_torch ops/trsm_kernel.py,
csrc/trsm.cu's wave_solve_kernel), on the CPU.

- ``wavefront_order`` lists every output block (block row, strip) once,
  the skipped ones of the inverse and of ``tril_rhs`` excepted; every item
  an item waits on holds a smaller ticket (the kernel's freedom from
  deadlock); no item lies above its strip's first block row.
- The launcher hands the entry point a zeroed int32 scratch of the size
  ``wavefront_order`` gives.
- ``solve_lower`` on q_mu's [M, 8] right side, both ways, at ragged M
  against the JAX package's ``solve_lower`` at f64 (value and the gradients
  of L and B within 1e-9 of each output's largest entry), and in f32
  against the Pallas blocked TRSM in interpret mode (2e-3 of the largest
  entry, tests/test_torch_linalg.py's bound: the Pallas kernel casts to
  f32, so this comparison cannot run at f64).
"""
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import linalg as jl
from modulatedgps_tpu.ops import pallas_linalg as PL

from modulatedgps_tpu_torch import _native
from modulatedgps_tpu_torch.ops import linalg as tl
from modulatedgps_tpu_torch.ops import trsm_kernel

BS = trsm_kernel.BLOCK
WIDE = trsm_kernel.WIDE_MIN_NB


def _cases():
    """(M, Nb, unit_rhs, tril_rhs, trans) of the order tests."""
    out = []
    for M in (1, 64, 65, 200, 4096):
        out.append((M, M, True, False, False))
        for Nb in (1, 8, 77, 4095):
            for trans in (False, True):
                out.append((M, Nb, False, False, trans))
            if Nb % M == 0:
                out.append((M, Nb, False, True, False))
    return out


def _skip_start(M, Nb, unit_rhs, tril_rhs, trans, W):
    """The first block row of each strip that the walk computes."""
    nstrips = -(-Nb // W)
    skip = not trans and (unit_rhs or tril_rhs)
    return [trsm_kernel.first_block(s * W, W, M, Nb) if skip else 0
            for s in range(nstrips)]


@pytest.mark.parametrize("M, Nb, unit_rhs, tril_rhs, trans", _cases())
def test_wavefront_order_covers_each_output_once_after_its_dependencies(
        M, Nb, unit_rhs, tril_rhs, trans):
    items, words = trsm_kernel.wavefront_order(M, Nb, unit_rhs, tril_rhs, trans)
    W = trsm_kernel.wavefront_width(Nb, unit_rhs)
    assert W == (64 if unit_rhs or Nb >= trsm_kernel.NARROW_MAX_NB else 8)
    nblk, nstrips = -(-M // BS), -(-Nb // W)
    kstart = _skip_start(M, Nb, unit_rhs, tril_rhs, trans, W)
    want = {(k, s) for s in range(nstrips) for k in range(kstart[s], nblk)}
    assert len(items) == len(set(items)) and set(items) == want
    assert words == 1 + nblk * nstrips
    ticket = {item: t for t, item in enumerate(items)}
    for (k, s), t in ticket.items():
        assert k >= kstart[s]
        deps = range(k + 1, nblk) if trans else range(kstart[s], k)
        assert all(ticket[(j, s)] < t for j in deps)


def test_wavefront_order_is_empty_where_the_wide_kernel_runs():
    assert trsm_kernel.wavefront_order(4096, WIDE) == ([], 0)
    assert trsm_kernel.wavefront_order(64, 8192, tril_rhs=True) == ([], 0)
    assert trsm_kernel.wavefront_width(WIDE, False) is None
    assert trsm_kernel.wavefront_width(8192, True) == 64


def test_inverse_order_walks_rows_then_the_strips_that_reach_them():
    items, _ = trsm_kernel.wavefront_order(200, 200, unit_rhs=True)
    assert items == [(0, 0), (1, 0), (1, 1), (2, 0), (2, 1), (2, 2),
                     (3, 0), (3, 1), (3, 2), (3, 3)]
    items, _ = trsm_kernel.wavefront_order(200, 8, trans=True)
    assert items == [(3, 0), (2, 0), (1, 0), (0, 0)]


class _OnTheCard:
    """Stands in for a CUDA tensor for the launcher's checks."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape, self.ndim = t.dtype, t.shape, t.ndim
        self.requires_grad = False

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.mark.parametrize("M, Nb, case", [
    (8, None, "inverse"), (130, None, "inverse"), (70, 8, "narrow"),
    (70, 77, "narrow"), (70, 70, "tril_rhs"), (70, 8, "transposed"),
    (8, WIDE, "wide"), (8, WIDE, "wide transposed")])
def test_launcher_passes_a_zeroed_scratch_of_the_order_size(M, Nb, case):
    calls, scratch = [], []

    class Lib:
        def mgp_trsm_lower(self, *args):
            calls.append(args)
            return 0

        def mgp_trsm_lower_t(self, *args):
            calls.append(args)
            return 0

    real_empty, real_zeros = torch.empty, torch.zeros
    cpu_empty = lambda *a, device=None, **kw: real_empty(*a, **kw)  # noqa: E731

    def cpu_zeros(*a, device=None, **kw):
        scratch.append(real_zeros(*a, **kw))
        return scratch[-1]

    trans = case.endswith("transposed")
    L = _OnTheCard(torch.eye(M))
    B = None if Nb is None else _OnTheCard(torch.ones(M, Nb))
    fn = trsm_kernel.trsm_lower_t if trans else trsm_kernel.trsm_lower
    kw = {"tril_rhs": True} if case == "tril_rhs" else {}
    before = fn.launches
    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 5), \
            mock.patch.object(trsm_kernel.torch, "empty", cpu_empty), \
            mock.patch.object(trsm_kernel.torch, "zeros", cpu_zeros):
        fn(L, B, **kw)
    fn.launches = before
    (args,), (work,) = calls, scratch
    width = M if Nb is None else Nb
    _, words = trsm_kernel.wavefront_order(M, width, Nb is None,
                                           case == "tril_rhs", trans)
    assert args[4] == work.data_ptr() and work.dtype == torch.int32
    assert work.numel() == words and not work.any()
    assert (words == 0) == case.startswith("wide")


def _factor(M, seed):
    rng = np.random.default_rng(seed)
    Z = rng.uniform(-3, 3, size=(M, 3))
    d2 = ((Z[:, None] - Z[None]) ** 2).sum(-1)
    return np.linalg.cholesky(np.exp(-0.5 * d2 / 0.8) + 1e-2 * np.eye(M)), rng


def _close(got, want, rtol):
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol,
                               atol=rtol * max(np.abs(want).max(), 1e-300))


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("M", [70, 130])
def test_narrow_solve_lower_matches_jax_f64_in_value_and_gradients(M, trans):
    """q_mu's solve (Nb = K = 8) and its pullback, both ways."""
    L, rng = _factor(M, M + trans)
    B = rng.normal(size=(M, 8))
    G = rng.normal(size=(M, 8))    # the cotangent of X
    def f(l, b):
        return jnp.sum(jl.solve_lower(l, b, trans=trans) * G)

    val, (gL, gB) = jax.value_and_grad(f, argnums=(0, 1))(jnp.asarray(L),
                                                          jnp.asarray(B))
    Lt = torch.tensor(L, requires_grad=True)
    Bt = torch.tensor(B, requires_grad=True)
    X = tl.solve_lower(Lt, Bt, trans=trans)
    (X * torch.tensor(G)).sum().backward()
    _close(X.detach().numpy(), np.asarray(jl.solve_lower(
        jnp.asarray(L), jnp.asarray(B), trans=trans)), 1e-9)
    loss = float((X.detach() * torch.tensor(G)).sum())
    np.testing.assert_allclose(loss, float(val), rtol=1e-9)
    # JAX's L cotangent is dense; the solve reads only L's lower triangle.
    _close(Lt.grad.numpy(), np.tril(np.asarray(gL)), 1e-9)
    _close(Bt.grad.numpy(), np.asarray(gB), 1e-9)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("M", [70, 130])
def test_narrow_solve_f32_matches_the_pallas_trsm_in_interpret_mode(M, trans):
    L64, rng = _factor(M, 7 * M + trans)
    L = L64.astype(np.float32)
    B = rng.normal(size=(M, 8)).astype(np.float32)
    want = np.asarray(PL.solve_triangular_blocked(
        jnp.asarray(L), jnp.asarray(B), True, trans, True))
    got = tl.solve_lower(torch.as_tensor(L), torch.as_tensor(B),
                         trans=trans).numpy()
    scale = np.abs(want).max()
    assert got.dtype == np.float32 and got.shape == (M, 8)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3 * scale)
