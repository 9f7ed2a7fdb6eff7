"""The tril backward launchers' alignment rule (modulatedgps_tpu_torch
ops/tril_kernel.py, csrc/tril_bwd.cu), on the CPU with the kernel library
mocked.

The backward kernels read their operands through TMA tensor maps, which
need 16-byte row strides: A16 [M, N] and G [K, N] get zero columns to a
multiple of 8, L16 [K, M, M] zero rows and columns, and B16 / W16 [K, N, M]
zero columns, each only where N or M is not a multiple of 8.  These tests
check that the padding leaves each plain product unchanged (exactly: the
padded entries are zeros and the kernels store only the [M, N] / [K, M, M]
corner) and that each entry point gets the padded strides.
"""
import unittest.mock as mock

import numpy as np
import pytest
import torch

from modulatedgps_tpu_torch import _native
from modulatedgps_tpu_torch.ops import tril_kernel

K = 2
SHAPES = [(136, 264), (200, 77), (197, 333), (1, 5)]


def _operands(M, N):
    rng = np.random.default_rng(M * 1000 + N)
    A16 = torch.as_tensor(rng.normal(size=(M, N))).to(torch.bfloat16)
    L16 = torch.as_tensor(rng.normal(size=(K, M, M))).to(torch.bfloat16)
    B16 = torch.as_tensor(rng.normal(size=(K, N, M))).to(torch.bfloat16)
    G = torch.as_tensor(rng.normal(size=(K, N)), dtype=torch.float32)
    return A16, L16, B16, G


def _up8(n):
    return -(-n // 8) * 8


@pytest.mark.parametrize("M, N", SHAPES)
def test_bwd_padding_shapes_and_zeros(M, N):
    """Each operand is padded with zeros to 8-aligned rows, and is passed
    through as it is where it already has them."""
    A16, L16, B16, G = _operands(M, N)
    ldn, ldm = _up8(N), _up8(M)
    Ap, Bp, Gp = tril_kernel._tma_bwd_operands(A16, B16, G)
    Lp, Bp2, none = tril_kernel._tma_bwd_operands(L16, B16)
    assert Ap.shape == (M, ldn) and Gp.shape == (K, ldn)
    assert Lp.shape == (K, ldm, ldm) and Bp.shape == Bp2.shape == (K, N, ldm)
    assert none is None
    assert (Ap is A16) == (ldn == N) and (Gp is G) == (ldn == N)
    assert (Lp is L16) == (ldm == M) and (Bp is B16) == (ldm == M)
    assert not Ap[:, N:].any() and not Gp[:, N:].any()
    assert not Lp[:, M:].any() and not Lp[:, :, M:].any()
    assert not Bp[:, :, M:].any()
    assert torch.equal(Ap[:, :N], A16) and torch.equal(Lp[:, :M, :M], L16)
    assert torch.equal(Bp[:, :, :M], B16) and torch.equal(Gp[:, :N], G)


@pytest.mark.parametrize("M, N", SHAPES)
@pytest.mark.parametrize("product", ["dl", "da", "sq_dl", "sq_da"])
def test_bwd_padding_leaves_the_plain_products_unchanged(M, N, product):
    """The product of the padded operands, cut to the output's corner, is
    the product of the operands: bit for bit, since the padding adds only
    exact zeros to each fp32 sum."""
    A16, L16, B16, G = _operands(M, N)
    scaled = product.startswith("sq")
    if product.endswith("dl"):
        Xp, Bp, Gp = tril_kernel._tma_bwd_operands(A16, B16, G)
        # The kernel reads B16's rows past N as zeros (TMA's fill), so the
        # contraction runs over A16's and G's padded columns too.
        Wp = torch.nn.functional.pad(Bp, (0, 0, 0, Xp.shape[1] - N))
        if scaled:
            got = tril_kernel.tril_sq_dl_plain(Xp, Wp, Gp)
            want = tril_kernel.tril_sq_dl_plain(A16, B16, G)
        else:
            got = tril_kernel.tril_dl_plain(Xp, Wp)
            want = tril_kernel.tril_dl_plain(A16, B16)
        got = got[:, :M, :M]
    else:
        Xp, Bp, Gp = tril_kernel._tma_bwd_operands(L16, B16, G)
        if scaled:
            got = tril_kernel.tril_sq_da_plain(Xp, Bp, Gp[:, :N])
            want = tril_kernel.tril_sq_da_plain(L16, B16, G)
        else:
            got = tril_kernel.tril_da_plain(Xp, Bp)
            want = tril_kernel.tril_da_plain(L16, B16)
        got = got[:M]
    assert got.dtype == torch.float32
    assert torch.equal(got, want)


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


CASES = {   # wrapper -> (entry point, operand, takes G, product)
    "tril_sq_dl": ("mgp_tril_dl", "A16", True, "dl"),
    "tril_sq_da": ("mgp_tril_da", "L16", True, "da"),
    "tril_dl": ("mgp_tril_dl_w", "A16", False, "dl"),
    "tril_da": ("mgp_tril_da_w", "L16", False, "da"),
}


@pytest.mark.parametrize("M, N", SHAPES)
@pytest.mark.parametrize("name", list(CASES))
def test_bwd_launcher_passes_the_padded_strides(M, N, name):
    """The entry point gets the padded operands' pointers, (M, N, K), the
    padded row strides (ldn = N and ldm = M rounded up to multiples of 8:
    A16's and G's, then B16's for dL; L16's and B16's, then G's for dA)
    and the stream; the output is allocated unpadded and the launch
    counted."""
    entry, operand, takes_g, product = CASES[name]
    A16, L16, B16, G = _operands(M, N)
    X16 = A16 if operand == "A16" else L16
    ldn, ldm = _up8(N), _up8(M)
    calls, padded = [], []

    class Lib:
        pass

    setattr(Lib, entry, lambda self, *args: calls.append(args) or 0)
    real_empty, real_pad = torch.empty, torch.nn.functional.pad
    cpu_empty = lambda *a, device=None, **kw: real_empty(*a, **kw)  # noqa: E731

    def card_pad(t, *a, **kw):
        out = _OnTheCard(real_pad(t.t, *a, **kw))
        padded.append(out)
        return out

    fn = getattr(tril_kernel, name)
    before = fn.launches
    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 77), \
            mock.patch.object(tril_kernel.torch, "empty", cpu_empty), \
            mock.patch.object(tril_kernel.torch.nn.functional, "pad", card_pad):
        ins = [_OnTheCard(X16), _OnTheCard(B16)] + ([_OnTheCard(G)]
                                                     if takes_g else [])
        out = fn(*ins)
    (args,) = calls
    want_shape = (K, M, M) if product == "dl" else (M, N)
    assert out.shape == want_shape and out.dtype == torch.float32
    n_ptrs = 4 if takes_g else 3
    assert args[n_ptrs - 1] == out.data_ptr()
    # Each pointer is the operand's own where it needed no padding, else
    # the padded copy's.
    ptrs = iter(args[:n_ptrs - 1])
    by_ptr = {t.data_ptr(): t for t in ins + padded}
    X_in, B_in = by_ptr[next(ptrs)], by_ptr[next(ptrs)]
    assert (X_in is ins[0]) == (X_in.shape == X16.shape)
    assert (B_in is ins[1]) == (ldm == M)
    assert B_in.shape == (K, N, ldm)
    if product == "dl":
        assert X_in.shape == (M, ldn)
        lds = (ldn, ldm)
    else:
        assert X_in.shape == (K, ldm, ldm)
        lds = (ldm, ldn) if takes_g else (ldm,)
    if takes_g:
        G_in = by_ptr[next(ptrs)]
        assert G_in.shape == (K, ldn) and (G_in is ins[2]) == (ldn == N)
    assert args[n_ptrs:] == (M, N, K, *lds, 77)
    assert fn.launches == before + 1
    fn.launches = before


def test_bwd_launcher_signatures_match_the_loader():
    """The loader's ctypes argument lists have one entry per argument the
    launchers pass: the pointers, (M, N, K), the strides, the stream."""
    sig = _native._SIGNATURES
    assert len(sig["mgp_tril_dl"]) == 4 + 3 + 2 + 1
    assert len(sig["mgp_tril_da"]) == 4 + 3 + 2 + 1
    assert len(sig["mgp_tril_dl_w"]) == 3 + 3 + 2 + 1
    assert len(sig["mgp_tril_da_w"]) == 3 + 3 + 1 + 1
