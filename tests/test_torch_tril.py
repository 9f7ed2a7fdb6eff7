"""The q_sqrt variance term of modulatedgps_tpu_torch and its gradient
against the JAX Pallas kernels.

The port's atl_sq_colsum on CPU tensors runs the plain version of the tril
kernel: bf16(A^T tril L) with f32 accumulation, squared and summed.  It is
held against JAX atl_sq_colsum with every pallas_call patched to interpret
mode, at M=768 (BM 256, 3 block rows), N=300 (padded to the TPU's TN
inside JAX), K=2, with non-zero garbage above L's diagonal.  Tolerance:
rtol 2e-2 and atol 1e-2 * max, the bf16 bound of tests/test_pallas_tril.py:
both hold B in bf16, and a product that rounds to the other side of a bf16
step moves by ~0.4%.  The gradients (the dL / dA kernels' plain versions
behind the autograd Function) are held against JAX atl_sq_colsum's custom
VJP, also in interpret mode, at that suite's gradient tolerance: 3e-2
(rtol, and atol as a fraction of the largest magnitude).

The 3-pass split (atl_sq_colsum with split, its forward
tril_sq_fwd_split) is held against the float64 product of the float32
operands: its B, extra and dA land 10-100x closer to it than one bf16
pass.
"""
import contextlib
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import pallas_tril as ptl

from modulatedgps_tpu_torch.ops import tril_kernel
from modulatedgps_tpu_torch.ops.tril_kernel import (atl_sq_colsum,
                                                    split_bf16,
                                                    tril_sq_da,
                                                    tril_sq_dl,
                                                    tril_sq_fwd,
                                                    tril_sq_fwd_plain,
                                                    tril_sq_fwd_split,
                                                    tril_sq_fwd_split_plain)

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


def test_sq_colsum_gradients_match_pallas_interpret(data):
    A, L = data
    w = np.random.default_rng(1).normal(size=(K, N)).astype(np.float32)

    def jloss(A, L):
        return jnp.sum(jnp.asarray(w) * ptl.atl_sq_colsum(A, L))

    with _interpret():
        want = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(A), jnp.asarray(L))
    At = torch.tensor(A, requires_grad=True)
    Lt = torch.tensor(L, requires_grad=True)
    (torch.as_tensor(w) * atl_sq_colsum(At, Lt)).sum().backward()
    assert At.grad.dtype == torch.float32 and Lt.grad.dtype == torch.float32
    for got, ref in ((At.grad, want[0]), (Lt.grad, want[1])):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=3e-2,
                                   atol=3e-2 * np.abs(ref).max())
    assert not torch.triu(Lt.grad, 1).any()


def test_backward_plain_versions_match_f64_dense(data):
    """dL and dA of bf16 operands with fp32 accumulation are within fp32
    rounding of the f64 products of the same bf16 values (W rounded to bf16
    once, as the kernels do)."""
    A, L = data
    A16 = torch.as_tensor(A).to(torch.bfloat16)
    L16 = torch.as_tensor(L).to(torch.bfloat16)
    B16 = tril_sq_fwd(A16, L16)
    G = torch.as_tensor(np.random.default_rng(3).normal(size=(K, N)),
                        dtype=torch.float32)
    W = (B16.float() * G[:, :, None]).to(torch.bfloat16).double()
    dL_exact = torch.tril(A16.double() @ W)
    dA_exact = (torch.tril(L16.double()) @ W.transpose(1, 2)).sum(0)
    for got, exact in ((tril_sq_dl(A16, B16, G), dL_exact),
                       (tril_sq_da(L16, B16, G), dA_exact)):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.double().numpy(), exact.numpy(),
                                   rtol=1e-5, atol=1e-5 * exact.abs().max().item())
    assert not torch.triu(tril_sq_dl(A16, B16, G), 1).any()


def test_tril_bwd_rejects_bad_shapes():
    A16 = torch.zeros(4, 3, dtype=torch.bfloat16)
    B16 = torch.zeros(2, 3, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        tril_sq_dl(A16, B16, torch.zeros(2, 4))
    with pytest.raises(ValueError):
        tril_sq_da(torch.zeros(2, 5, 5, dtype=torch.bfloat16), B16,
                   torch.zeros(2, 3))
    with pytest.raises(ValueError):
        tril_sq_dl(A16, torch.zeros(3, 4, dtype=torch.bfloat16),
                   torch.zeros(2, 3))


def test_tril_fwd_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tril_sq_fwd(torch.zeros(4, 3, dtype=torch.bfloat16),
                    torch.zeros(2, 5, 5, dtype=torch.bfloat16))


class _OnTheCard:
    """Stands in for a CUDA tensor for the launcher's checks and padding:
    its device reads as the card, its data is a CPU tensor's."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape, self.ndim = t.dtype, t.shape, t.ndim
        self.requires_grad = False

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr()


@pytest.mark.parametrize("M, N", [(136, 264), (200, 77), (197, 333), (1, 5)])
def test_tril_fwd_launcher_pads_to_tma_strides(M, N):
    """The forward kernel's alignment rule: the entry point gets A16 with
    lda = N rounded up to a multiple of 8 and L16 with ldl = M rounded up,
    zero-padded where they differ (the operands themselves where not), and
    the padding leaves the product on the [N, M] corner unchanged."""
    from modulatedgps_tpu_torch import _native
    from modulatedgps_tpu_torch.ops import tril_kernel
    rng = np.random.default_rng(M)
    A16 = torch.as_tensor(rng.normal(size=(M, N))).to(torch.bfloat16)
    L16 = torch.as_tensor(rng.normal(size=(2, M, M))).to(torch.bfloat16)
    Ap, Lp = tril_kernel._tma_operands(A16, L16)
    lda, ldl = -(-N // 8) * 8, -(-M // 8) * 8
    assert Ap.shape == (M, lda) and Lp.shape == (2, ldl, ldl)
    assert (Ap is A16) == (lda == N) and (Lp is L16) == (ldl == M)
    assert not Ap[:, N:].any() and not Lp[:, M:].any() and not Lp[:, :, M:].any()
    # TMA reads A's rows past M as zeros: the same product with them added
    Ap_rows = torch.nn.functional.pad(Ap, (0, 0, 0, ldl - M))
    got = tril_sq_fwd_plain(Ap_rows, Lp)[:, :N, :M]
    assert torch.equal(got, tril_sq_fwd_plain(A16, L16))

    calls = []

    class Lib:
        def mgp_tril_fwd(self, *args):
            calls.append(args)
            return 0

    real_empty, real_pad = torch.empty, torch.nn.functional.pad
    cpu_empty = lambda *a, device=None, **kw: real_empty(*a, **kw)  # noqa: E731
    card_pad = lambda t, *a, **kw: _OnTheCard(real_pad(t.t, *a, **kw))  # noqa: E731
    before = tril_sq_fwd.launches
    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 77), \
            mock.patch.object(tril_kernel.torch, "empty", cpu_empty), \
            mock.patch.object(tril_kernel.torch.nn.functional, "pad", card_pad):
        B = tril_sq_fwd(_OnTheCard(A16), _OnTheCard(L16))
    assert B.shape == (2, N, M) and B.dtype == torch.bfloat16
    (args,) = calls
    assert args[3:] == (M, N, 2, lda, ldl, 77) and args[2] == B.data_ptr()
    assert tril_sq_fwd.launches == before + 1
    tril_sq_fwd.launches = before


def _split_operands(A, L):
    """A2 [2, M, N] and L2 [2K, M, M]: the split forward's operands."""
    A2, L3 = tril_kernel._split_operands(A, L)
    return A2, L3[:2 * L.shape[0]]


def test_split_bf16_carries_the_low_part(data):
    A, _ = data
    At = torch.as_tensor(A)
    A2 = split_bf16(At, torch.empty((2, M, N), dtype=torch.bfloat16))
    assert A2[1].float().abs().max() > 0
    one = (A2[0].double() - At.double()).abs().max()
    two = (A2[0].double() + A2[1].double() - At.double()).abs().max()
    assert two <= one * 2 ** -7


def test_split_fwd_plain_beats_one_bf16_pass(data):
    """B and extra of the 3-pass split: within 1e-4 of the f64 product of
    the fp32 operands (relative to the largest magnitude), at least 30x
    closer than one bf16 pass."""
    A, L = data
    At, Lt = torch.as_tensor(A), torch.as_tensor(L)
    exact = At.double().T @ torch.tril(Lt.double())
    B, extra = tril_sq_fwd_split(*_split_operands(At, Lt))
    one = tril_sq_fwd_plain(At.bfloat16(), Lt.bfloat16()).double()
    assert B.dtype == torch.float32 and extra.dtype == torch.float32
    scale = exact.abs().max()
    err, err1 = ((b.double() - exact).abs().max() / scale for b in (B, one))
    assert err < 1e-4 and err < err1 / 30
    e_exact = exact.square().sum(-1)
    e_err = (extra.double() - e_exact).abs().max() / e_exact.max()
    e_one = (one.square().sum(-1) - e_exact).abs().max() / e_exact.max()
    assert e_err < 1e-5 and e_err < e_one / 30


def test_split_sq_colsum_value_and_gradients_against_f64(data):
    """atl_sq_colsum(split=True) against the f64 dense value and gradient:
    the value within 1e-5, dA (3 passes) within 2e-3 and 10x closer than
    one pass, dL (one pass) within 3e-2."""
    A, L = data
    w = torch.as_tensor(np.random.default_rng(1).normal(size=(K, N)))
    grads, values = {}, {}
    split = True
    for dtype, sp in ((torch.float64, split), (torch.float32, split),
                      (torch.float32, False)):
        At = torch.tensor(A, dtype=dtype, requires_grad=True)
        Lt = torch.tensor(L, dtype=dtype, requires_grad=True)
        if dtype == torch.float64:
            value = (At.T[None] @ torch.tril(Lt)).square().sum(-1)
        else:
            value = atl_sq_colsum(At, Lt, sp)
        (w.to(dtype) * value).sum().backward()
        key = (dtype, sp)
        values[key] = value.detach().double()
        grads[key] = (At.grad.double(), Lt.grad.double())
    exact, (dA64, dL64) = values[(torch.float64, split)], grads[(torch.float64, split)]
    rel = lambda got, want: float((got - want).abs().max() / want.abs().max())
    got, (dA, dL) = values[(torch.float32, split)], grads[(torch.float32, split)]
    one_dA = grads[(torch.float32, False)][0]
    assert rel(got, exact) < 1e-5
    assert rel(values[(torch.float32, False)], exact) > 30 * rel(got, exact)
    assert rel(dL, dL64) < 3e-2 and not torch.triu(dL, 1).any()
    assert rel(dA, dA64) < 2e-3 and rel(dA, dA64) < rel(one_dA, dA64) / 10


@pytest.mark.parametrize("M, N", [(136, 264), (200, 77), (197, 333), (1, 5)])
def test_tril_fwd_split_launcher_pads_to_tma_strides(M, N):
    """The split entry point gets A2 [2, M, lda] and L2 [2K, ldl, ldl],
    zero-padded to multiples of 8 where N or M is not one, B [K, N, M] f32,
    part [K, ceil(M / 256), N] and extra [K, N]; each call adds one
    launch."""
    from modulatedgps_tpu_torch import _native
    rng = np.random.default_rng(M)
    A2 = torch.as_tensor(rng.normal(size=(2, M, N))).to(torch.bfloat16)
    L2 = torch.as_tensor(rng.normal(size=(4, M, M))).to(torch.bfloat16)
    lda, ldl = -(-N // 8) * 8, -(-M // 8) * 8
    calls = []

    class Lib:
        def mgp_tril_fwd_split(self, *args):
            calls.append(args)
            return 0

    real_empty, real_pad = torch.empty, torch.nn.functional.pad
    made = []

    def cpu_empty(*a, device=None, **kw):
        made.append(real_empty(*a, **kw))
        return made[-1]

    card_pad = lambda t, *a, **kw: _OnTheCard(real_pad(t.t, *a, **kw))  # noqa: E731
    before = tril_sq_fwd_split.launches
    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 77), \
            mock.patch.object(tril_kernel.torch, "empty", cpu_empty), \
            mock.patch.object(tril_kernel.torch.nn.functional, "pad", card_pad):
        B, extra = tril_sq_fwd_split(_OnTheCard(A2), _OnTheCard(L2))
    assert B.shape == (2, N, M) and B.dtype == torch.float32
    assert extra.shape == (2, N) and extra.dtype == torch.float32
    (args,) = calls
    part = made[1]
    assert part.shape == (2, -(-M // 256), N)
    assert args[2:5] == (B.data_ptr(), part.data_ptr(), extra.data_ptr())
    assert args[5:] == (M, N, 2, lda, ldl, 77)
    assert tril_sq_fwd_split.launches == before + 1
    tril_sq_fwd_split.launches = before


def test_tril_fwd_split_rejects_bad_shapes():
    with pytest.raises(ValueError):
        tril_sq_fwd_split(torch.zeros(4, 3, dtype=torch.bfloat16),
                          torch.zeros(2, 4, 4, dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        tril_sq_fwd_split(torch.zeros(2, 4, 3, dtype=torch.bfloat16),
                          torch.zeros(3, 4, 4, dtype=torch.bfloat16))


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (chip_smoke.py runs it there)")
    return torch.device("cuda")


@pytest.mark.parametrize("M, N, Kc", [(200, 77, 3), (197, 333, 2),
                                      (1024, 2048, 8)])
def test_tril_fwd_split_kernel_extra_matches_plain(card, M, N, Kc):
    """On the card: the split kernel's B and extra (the square sums from its
    fp32 accumulators) within 1e-4 of the plain version's largest
    magnitude, with NaN above L's diagonal."""
    g = torch.Generator().manual_seed(M)
    A = (torch.randn(M, N, generator=g) / M ** 0.5).to(card)
    L = (torch.eye(M) + 0.05 * torch.randn(Kc, M, M, generator=g)).to(card)
    L = L + torch.triu(torch.full_like(L, float("nan")), 1)
    A2, L2 = _split_operands(A, L)
    B, extra = tril_sq_fwd_split(A2, L2)
    torch.cuda.synchronize()
    want, want_extra = tril_sq_fwd_split_plain(A2, L2)
    torch.testing.assert_close(extra, want_extra, rtol=1e-4,
                               atol=1e-4 * float(want_extra.max()))
    torch.testing.assert_close(B, want, rtol=1e-4,
                               atol=1e-4 * float(want.abs().max()))
