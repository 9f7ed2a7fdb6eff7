"""The Cholesky pullback's products on TMA and wgmma (modulatedgps_tpu_torch
ops/trimm_kernel.py, csrc/trimm.cu), on the CPU.

- The kernel's tile list (``tile_order``) covers every 128 x 256 output tile
  once, longest band first; with ``tril_out`` it holds exactly the tiles
  with an entry on or below the diagonal (those above are stored as zeros,
  not computed).
- The split pass's plain version (``split_operands_plain``) is the masked
  operand's ``split_bf16``, bit for bit, with a non-zero lo part, and the
  3-pass product of its workspace, X^T Y over the band, is the plain
  products' result.
- The launchers hand the entry points a bf16 workspace of
  ``workspace_shape(M)`` and count their launches (the ctypes signatures
  are held against csrc/*.cu by tests/test_torch_trsm_wide.py).
"""
import unittest.mock as mock

import numpy as np
import pytest
import torch

from modulatedgps_tpu_torch import _native
from modulatedgps_tpu_torch.ops import trimm_kernel as tk

TI, TJ = tk.TILE_I, tk.TILE_J


@pytest.mark.parametrize("M", [1, 100, 128, 200, 256, 600, 4096])
@pytest.mark.parametrize("mode", ["tt", "tt tril_out", "nt"])
def test_tile_order_covers_each_tile_once_longest_band_first(M, mode):
    nt, tril_out = mode == "nt", mode.endswith("tril_out")
    order = tk.tile_order(M, nt=nt, tril_out=tril_out)
    ni, nj = -(-M // TI), -(-M // TJ)
    tiles = {(a, b) for a in range(ni) for b in range(nj)}
    if tril_out:   # a tile holds an entry with i >= j
        tiles = {(a, b) for a, b in tiles if TI * a + TI - 1 >= TJ * b}
    assert len(order) == len(set(order)) and set(order) == tiles
    start = [TJ * b if nt else max(TI * a, TJ * b) for a, b in order]
    assert start == sorted(start)     # the band walks k from here to M


def test_tril_out_schedules_no_tile_above_the_diagonal():
    M = 1000
    full, low = tk.tile_order(M), tk.tile_order(M, tril_out=True)
    above = set(full) - set(low)
    assert above and all(TI * a + TI - 1 < TJ * b for a, b in above)


@pytest.mark.parametrize("M", [1, 37, 200])
@pytest.mark.parametrize("nt", [False, True])
def test_split_pass_plain_is_split_bf16_of_the_masked_operand(M, nt):
    rng = np.random.default_rng(M + nt)
    A = torch.tensor(rng.normal(size=(M, M)), dtype=torch.float32)
    B = torch.tensor(rng.normal(size=(M, M)), dtype=torch.float32)
    B[torch.triu(torch.ones(M, M, dtype=torch.bool), 1)] = float("nan")
    ws = tk.split_operands_plain(A, B, nt=nt)
    assert ws.shape == tk.workspace_shape(M) and ws.dtype == torch.bfloat16
    assert ws.shape[2] % 8 == 0 and ws.shape[2] >= M
    X = A.T.contiguous() if nt else torch.tril(A)
    for q, t in enumerate((X, torch.tril(torch.nan_to_num(B)))):
        hi, lo = tk.split_bf16(t)
        bits = lambda x: x.view(torch.int16)   # noqa: E731
        assert torch.equal(bits(ws[2 * q, :, :M]), bits(hi))
        assert torch.equal(bits(ws[2 * q + 1, :, :M]), bits(lo))
        assert not ws[2 * q:2 * q + 2, :, M:].any()
        assert bool(torch.isfinite(ws[2 * q:2 * q + 2].float()).all())
        assert M == 1 or bool(ws[2 * q + 1].any())   # the lo part is there


@pytest.mark.parametrize("M", [37, 200])
@pytest.mark.parametrize("mode", ["tt", "tt tril_out", "nt"])
def test_workspace_product_is_the_plain_product(M, mode):
    """What the kernel computes from the workspace, X^T Y with the 3-pass
    split (hh + hl + lh) over the band, is the plain versions' result."""
    rng = np.random.default_rng(3 * M)
    A = torch.tensor(rng.normal(size=(M, M)), dtype=torch.float32)
    B = torch.tensor(rng.normal(size=(M, M)), dtype=torch.float32)
    nt = mode == "nt"
    ws = tk.split_operands_plain(A, B, nt=nt)[:, :, :M].double()
    Xh, Xl, Yh, Yl = ws
    C = Xh.T @ Yh + Xh.T @ Yl + Xl.T @ Yh
    if mode == "nt":
        want = tk.tri_nt_matmul_plain(A, B)
    else:
        want = tk.tri_tt_matmul_plain(A, B, tril_out=mode.endswith("tril_out"))
        if mode.endswith("tril_out"):
            C = torch.tril(C)
    np.testing.assert_allclose(C.numpy(), want.double().numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


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


@pytest.mark.parametrize("M", [8, 37])
@pytest.mark.parametrize("case", ["tt", "tt tril_out", "nt"])
def test_launchers_pass_the_workspace_and_count(M, case):
    calls, made = [], []

    class Lib:
        def mgp_tri_tt(self, *args):
            calls.append(("tt", args))
            return 0

        def mgp_tri_nt(self, *args):
            calls.append(("nt", args))
            return 0

    real_empty = torch.empty

    def cpu_empty(*a, device=None, **kw):
        made.append(real_empty(*a, **kw))
        return made[-1]

    A, B = _OnTheCard(torch.ones(M, M)), _OnTheCard(torch.ones(M, M))
    fn = tk.tri_nt_matmul if case == "nt" else tk.tri_tt_matmul
    kw = {} if case == "nt" else {"tril_out": case.endswith("tril_out")}
    before = fn.launches
    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 9), \
            mock.patch.object(tk.torch, "empty", cpu_empty):
        C = fn(A, B, **kw)
    assert fn.launches == before + 1
    fn.launches = before
    ((which, args),) = calls
    C_made, ws = made
    assert which == case[:2] and C is C_made and C.shape == (M, M)
    assert ws.shape == tk.workspace_shape(M) and ws.dtype == torch.bfloat16
    assert args[:5] == (A.data_ptr(), B.data_ptr(), C.data_ptr(),
                        ws.data_ptr(), M)
    tail = (9,) if case == "nt" else (int(case.endswith("tril_out")), 9)
    assert args[5:] == tail
