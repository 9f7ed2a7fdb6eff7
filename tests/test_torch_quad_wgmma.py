"""The fused q_sqrt quadratic's launcher on the tril forward's TMA product
(modulatedgps_tpu_torch ops/quad_kernel.py, csrc/quad.cu), on the CPU with
the kernel library mocked.

csrc/quad.cu reads S16 [K, M, M] and A16 [M, N] through TMA tensor maps,
which need 16-byte row strides, so the wrapper pads A16 with zero columns
and S16 with zero rows and columns to multiples of 8 where N or M is not
one; the kernel writes each (k, m'-tile of 256, n) row sum into the scratch
``part`` [K, ceil(M / 256), N], and a second launch adds the partial sums
of each (k, n) in order.  These tests check the padded strides and the
scratch the wrapper hands the entry point, that the padding leaves the
plain function unchanged, and that the partial sums over 256-wide m'-tiles
add up to the plain function (a tile missed or counted twice would not).
"""
import unittest.mock as mock

import numpy as np
import pytest
import torch

from modulatedgps_tpu_torch import _native
from modulatedgps_tpu_torch.ops import quad_kernel, tril_kernel

SHAPES = [(3, 200, 77), (2, 136, 264), (2, 1, 5), (1, 257, 300), (2, 520, 40)]


def _operands(K, M, N):
    rng = np.random.default_rng(K * 1000 + M + N)
    S = np.eye(M) + 0.05 * rng.normal(size=(K, M, M))
    S = S + np.triu(np.full((M, M), np.nan), 1)      # never read
    S16 = torch.as_tensor(S).to(torch.bfloat16)
    A16 = torch.as_tensor(rng.normal(size=(M, N)) / np.sqrt(M)).to(
        torch.bfloat16)
    return S16, A16


def _up8(n):
    return -(-n // 8) * 8


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


@pytest.mark.parametrize("K, M, N", SHAPES)
def test_quad_launcher_passes_padded_strides_and_scratch(K, M, N):
    """The entry point gets (S16, A16, part, out, M, N, K, lda, lds,
    stream): the padded operands where N or M is not a multiple of 8 (the
    operands themselves where it is), part [K, ceil(M / 256), N] and out
    [K, N] in f32, and the launch is counted."""
    S16, A16 = _operands(K, M, N)
    calls, padded, allocated = [], [], []

    class Lib:
        def mgp_qsqrt_sq_colsum(self, *args):
            calls.append(args)
            return 0

    real_empty, real_pad = torch.empty, torch.nn.functional.pad

    def cpu_empty(*a, device=None, **kw):
        out = real_empty(*a, **kw)
        allocated.append(out)
        return out

    def card_pad(t, *a, **kw):
        out = _OnTheCard(real_pad(t.t, *a, **kw))
        padded.append(out)
        return out

    ins = [_OnTheCard(S16), _OnTheCard(A16)]
    before = quad_kernel.qsqrt_sq_colsum.launches
    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 77), \
            mock.patch.object(quad_kernel.torch, "empty", cpu_empty), \
            mock.patch.object(tril_kernel.torch.nn.functional, "pad", card_pad):
        out = quad_kernel._sq_colsum(*ins)
    (args,) = calls
    by_ptr = {t.data_ptr(): t for t in ins + padded + allocated}
    S_in, A_in, part, out_in = (by_ptr[p] for p in args[:4])
    assert out_in is out and out.shape == (K, N) and out.dtype == torch.float32
    assert part.shape == (K, -(-M // quad_kernel.TILE_P), N)
    assert part.dtype == torch.float32
    lda, lds = _up8(N), _up8(M)
    assert A_in.shape == (M, lda) and (A_in is ins[1]) == (lda == N)
    assert S_in.shape == (K, lds, lds) and (S_in is ins[0]) == (lds == M)
    assert args[4:] == (M, N, K, lda, lds, 77)
    assert quad_kernel.qsqrt_sq_colsum.launches == before + 1
    quad_kernel.qsqrt_sq_colsum.launches = before


@pytest.mark.parametrize("K, M, N", SHAPES)
def test_quad_padding_leaves_the_plain_function_unchanged(K, M, N):
    """The plain function of the padded operands, cut to the output's
    columns, is the plain function of the operands: the padded rows and
    columns add exact zeros (the NaN above S's diagonal is never read)."""
    S16, A16 = _operands(K, M, N)
    A_p, S_p = tril_kernel._tma_operands(A16, S16)
    assert not A_p[:, N:].any() and not torch.nan_to_num(S_p[:, M:]).any()
    assert not torch.nan_to_num(S_p[:, :, M:]).any()
    want = quad_kernel.qsqrt_sq_colsum_plain(S16, A16)
    # The kernel reads A's rows past M as zeros (TMA's fill).
    A_pp = torch.nn.functional.pad(A_p, (0, 0, 0, S_p.shape[-1] - M))
    got = quad_kernel.qsqrt_sq_colsum_plain(S_p, A_pp)[:, :N]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6, atol=0)


@pytest.mark.parametrize("K, M, N", SHAPES)
def test_partial_row_sums_over_m_tiles_add_up(K, M, N):
    """quad.cu's decomposition: for each m'-tile of TILE_P columns, the row
    sums of the squared product over that tile (partial sums in part), then
    the partial sums added in order, equal the plain function."""
    S16, A16 = _operands(K, M, N)
    S32 = torch.tril(torch.nan_to_num(S16.float()))
    prod = S32.transpose(-1, -2) @ A16.float()                 # [K, M, N]
    tile = quad_kernel.TILE_P
    part = torch.stack([prod[:, p0:p0 + tile].square().sum(1)
                        for p0 in range(0, M, tile)], 1)       # [K, P, N]
    assert part.shape == (K, -(-M // tile), N)
    total = part[:, 0].clone()
    for p in range(1, part.shape[1]):
        total += part[:, p]
    want = quad_kernel.qsqrt_sq_colsum_plain(S16, A16)
    np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
