"""The KL forward sums as a streaming reduction (modulatedgps_tpu_torch
ops/kl_kernel.py, csrc/kl_tril.cu's kl_fwd_kernel) on the CPU.

The kernel splits the lower triangle of each Lq[k] into items, the row pairs
(p, M-1-p) up to the diagonal, in chunks of 4 floats (a row starts 16-byte
aligned) or of 1; a persistent grid's warps take every W-th item, a lane
every 32nd chunk of its item, and the lane whose chunk holds a row's
diagonal drops the entries past it and takes the log.  A numpy emulation of
that split covers every lower-triangle entry once, reads no chunk that lies
wholly above the diagonal and logs each diagonal once, for M in {1, 2, 130,
197, 4096}; its sums agree with the plain version in f64.  The plain version
is held against the Pallas kernel in interpret mode, and the launcher to the
f64 scratch the library sizes for its persistent grid, on a mocked library.
"""
import ctypes
import unittest.mock as mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops import pallas_kl

from modulatedgps_tpu_torch import _native
from modulatedgps_tpu_torch.ops import kl_kernel


def _split(M, CW):
    """Each item's chunks as (row, first column) arrays, item by item."""
    items = []
    for p in range((M + 1) // 2):
        q = M - 1 - p
        n1 = p // CW + 1
        n = n1 + (q // CW + 1 if q != p else 0)
        c = np.arange(n)
        row = np.where(c < n1, p, q)
        cc = np.where(c < n1, c, c - n1)
        items.append((row, cc * CW))
    return items


def _coverage(M, CW):
    """(entries read per (row, col) on and below the diagonal, logs per
    row, chunks wholly above the diagonal)."""
    rows, cols, diag = [], [], np.zeros(M, np.int64)
    above = 0
    for row, col0 in _split(M, CW):
        above += int((col0 > row).sum())
        holds = (col0 <= row) & (row < col0 + CW)       # the chunk with the diagonal
        np.add.at(diag, row[holds], 1)
        for t in range(CW):
            keep = col0 + t <= row                      # past the diagonal: dropped
            rows.append(row[keep])
            cols.append(col0[keep] + t)
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    counts = np.bincount(rows.astype(np.int64) * M + cols, minlength=M * M)
    return counts.reshape(M, M), diag, above


@pytest.mark.parametrize("M", [1, 2, 130, 197, 4096])
def test_work_split_covers_the_triangle_once(M):
    """Every entry on or below the diagonal is added once, none above it,
    no chunk lies wholly above the diagonal, and each diagonal is logged
    once; the items' chunk counts differ by at most 2 (equal shares), but
    for the middle row of an odd M, an item alone."""
    for CW in ((1, 4) if M % 4 == 0 else (1,)):
        counts, diag, above = _coverage(M, CW)
        assert above == 0
        assert np.array_equal(counts, np.tril(np.ones((M, M), np.int64)))
        assert np.array_equal(diag, np.ones(M, np.int64))
        sizes = [len(row) for row, _ in _split(M, CW)][:M // 2]
        assert not sizes or max(sizes) - min(sizes) <= 2


@pytest.mark.parametrize("K, M, warps", [(2, 130, 7), (3, 197, 64),
                                         (1, 1, 8), (8, 4096, 528 * 8)])
def test_items_go_to_warps_once(K, M, warps):
    """Warp w takes items w, w + W, ...: each (k, p) once, and no warp more
    than one item above another."""
    P = (M + 1) // 2
    taken = np.zeros(K * P, np.int64)
    per_warp = []
    for w in range(warps):
        its = np.arange(w, K * P, warps)
        taken[its] += 1
        per_warp.append(len(its))
    assert np.array_equal(taken, np.ones(K * P, np.int64))
    assert max(per_warp) - min(per_warp) <= 1


@pytest.mark.parametrize("M", [1, 2, 130, 197])
def test_split_sums_equal_the_plain_version(M):
    """The sums the split forms (squares of the kept entries, logs of the
    diagonals read in the diagonal's chunk) equal the plain version's in
    f64; the NaN above the diagonal is never added."""
    rng = np.random.default_rng(M)
    K = 2
    L = np.tril(0.05 * rng.normal(size=(K, M, M)), -1)
    L[:, np.arange(M), np.arange(M)] = 1.0 + 0.5 * rng.random((K, M))
    L = L + np.triu(np.full((M, M), np.nan), 1)
    want = kl_kernel.kl_sq_logdiag_plain(torch.as_tensor(L))
    for CW in ((1, 4) if M % 4 == 0 else (1,)):
        sq = ld = 0.0
        for k in range(K):
            for row, col0 in _split(M, CW):
                for r, c0 in zip(row, col0):
                    chunk = L[k, r, c0:c0 + CW]
                    cols = c0 + np.arange(len(chunk))
                    kept = np.where(cols <= r, chunk, 0.0)
                    sq += float(np.sum(kept * kept))
                    if c0 <= r < c0 + CW:
                        ld += float(np.log(abs(chunk[r - c0])))
        np.testing.assert_allclose(sq, float(want[0]), rtol=1e-12)
        np.testing.assert_allclose(ld, float(want[1]), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("M", [256, 512])
def test_plain_matches_pallas_interpret(M):
    """kl_sq_logdiag_plain against pallas_kl.kl_sq_logdiag in interpret mode
    (f32, rtol 1e-5: both sum f32 squares in other orders)."""
    rng = np.random.default_rng(M + 1)
    K = 2
    Lq = np.tril(0.05 * rng.normal(size=(K, M, M))).astype(np.float32)
    for k in range(K):
        np.fill_diagonal(Lq[k], np.abs(Lq[k].diagonal()) + 0.5)
    want = pallas_kl.kl_sq_logdiag(jnp.asarray(Lq), interpret=True)
    got = kl_kernel.kl_sq_logdiag(torch.as_tensor(Lq))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-5)


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


@pytest.mark.parametrize("K, M, slots", [(8, 4096, 1057), (3, 197, 1057),
                                         (1, 1, 913)])
def test_fwd_launcher_passes_grid_and_scratch(K, M, slots):
    """The library sizes the scratch for the card's grid (asked with the
    card's index); the entry point gets (Lq, partial, out, M, K, slots,
    stream), partial that many f64 (the CTAs' two sums each and the
    counter's slot: it derives the grid from it), out two f32; the launch
    is counted; a CUDA error from either entry raises."""
    Lq = _OnTheCard(torch.zeros(K, M, M))
    calls, allocated, asked = [], [], []

    class Lib:
        code = scratch_code = 0

        def mgp_kl_fwd_scratch(self, device, ptr):
            asked.append(device)
            ctypes.c_int.from_address(ptr).value = slots
            return Lib.scratch_code

        def mgp_kl_fwd(self, *args):
            calls.append(args)
            return Lib.code

    real_empty = torch.empty

    def cpu_empty(*a, device=None, **kw):
        out = real_empty(*a, **kw)
        allocated.append(out)
        return out

    before = kl_kernel.kl_sq_logdiag.launches
    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 77), \
            mock.patch.object(kl_kernel.torch, "empty", cpu_empty):
        sq, ld = kl_kernel.kl_sq_logdiag(Lq)
        Lib.code = 700
        with pytest.raises(RuntimeError, match="CUDA error 700"):
            kl_kernel.kl_sq_logdiag(Lq)
        Lib.scratch_code = 101
        with pytest.raises(RuntimeError, match="CUDA error 101"):
            kl_kernel.kl_sq_logdiag(Lq)
    assert asked[0] == 0 and len(calls) == 2
    args = calls[0]
    by_ptr = {t.data_ptr(): t for t in allocated}
    partial, out = by_ptr[args[1]], by_ptr[args[2]]
    assert args[0] == Lq.data_ptr() and args[3:] == (M, K, slots, 77)
    assert partial.dtype == torch.float64 and partial.numel() == slots
    assert out.dtype == torch.float32 and out.shape == (2,)
    assert sq.data_ptr() == out.data_ptr() and ld.shape == ()
    assert kl_kernel.kl_sq_logdiag.launches == before + 1
    kl_kernel.kl_sq_logdiag.launches = before
