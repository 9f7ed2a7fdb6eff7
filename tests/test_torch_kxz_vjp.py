"""The pullback of K(X, X2) (modulatedgps_tpu_torch ops/kxz_kernel.py,
csrc/kxz.cu's kxz_vjp_kernel and kxz_vjp_sum_kernel) on the CPU.

``kxz_vjp_plain`` is the closed form the CUDA pullback computes: with
W = Kbar var phi'(d2) [raw d2 >= 0] (torch's clamp_min convention),
xs_bar = 2 (xs W1 - W zs), X_bar = xs_bar / l, l_bar = -(sum xs_bar xs +
sum zs_bar zs) / l, var_bar = sum Kbar phi.  It is held against JAX's
custom_vjp (jax.vjp of rbf_kxz / matern32_kxz, the Pallas forward in
interpret mode, the backward the dense formula's XLA gradient) in f64 at
1e-10, and against autograd through ``kxz_plain``, for both kinds, scalar
and ARD lengthscales, K(Z, X) and K(Z, Z) with one tensor on both sides,
every subset of the gradients asked for and ragged N, M, D (D = 130 on the
kernels' chunked generic path too).  A torch
emulation of the kernel's tiles (128 columns by 256 rows, partial row and
column sums in the workspace's layout, added in a fixed order by a second
pass) agrees with the closed form at f32 tolerance and gives the same bits
twice.  The launcher is held to its arguments and workspace on a mocked
library, and the autograd Function's backward to launching it (no eager
recompute, no fallback when the launch fails).
"""
import itertools
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from modulatedgps_tpu.ops.pallas_kernels import matern32_kxz, rbf_kxz

from modulatedgps_tpu_torch import _native
from modulatedgps_tpu_torch.ops import kxz_kernel

SUBSETS = [s for s in itertools.product((False, True), repeat=4) if any(s)]
SHAPES = [(301, 37, 3), (64, 129, 4), (40, 9, 130)]


def _inputs(N, M, D, ard, same, dtype=np.float64, seed=0):
    rng = np.random.default_rng(seed + 7 * N + M + D)
    X = rng.normal(size=(N, D)).astype(dtype)
    X2 = X if same else rng.uniform(-2, 2, size=(M, D)).astype(dtype)
    ls = (np.linspace(0.6, 1.4, D).astype(dtype) if ard
          else np.asarray(0.8, dtype))
    if D > 16:                                # keep d2 near 1 a coordinate
        ls = (ls * np.sqrt(D / 4)).astype(dtype)
    var = np.asarray(0.7, dtype)
    Kbar = rng.normal(size=(N, X2.shape[0])).astype(dtype)
    return X, X2, ls, var, Kbar


def _jax_grads(kind, X, X2, ls, var, Kbar):
    """(X_bar, X2_bar, l_bar, var_bar) from JAX's custom_vjp, X and X2 as
    separate arguments."""
    fn = rbf_kxz if kind == "rbf" else matern32_kxz
    _, vjp = jax.vjp(lambda a, b, v, l: fn(a, b, v, l, True), jnp.asarray(X),
                     jnp.asarray(X2), jnp.asarray(var), jnp.asarray(ls))
    gx, gz, gv, gl = vjp(jnp.asarray(Kbar))
    return [np.asarray(t) for t in (gx, gz, gl, gv)]


@pytest.mark.parametrize("N, M, D", SHAPES)
@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_vjp_plain_matches_jax_custom_vjp(kind, ard, same, N, M, D):
    """Every subset of the gradients at 1e-10 of JAX's (f64); for K(Z, Z)
    the two parts also add up to JAX's gradient of the one tensor."""
    X, X2, ls, var, Kbar = _inputs(N, M, D, ard, same)
    want = _jax_grads(kind, X, X2, ls, var, Kbar)
    ins = [torch.as_tensor(t) for t in (X, X2, ls, var, Kbar)]
    if same:
        ins[1] = ins[0]
    for needs in SUBSETS:
        got = kxz_kernel.kxz_vjp_plain(*ins, kind, needs)
        for g, w, n in zip(got, want, needs):
            if not n:
                assert g is None
                continue
            assert g.shape == w.shape and g.dtype == torch.float64
            np.testing.assert_allclose(g.numpy(), w, rtol=1e-10,
                                       atol=1e-10 * np.abs(w).max())
    if same:
        fn = rbf_kxz if kind == "rbf" else matern32_kxz
        total = jax.grad(lambda z: jnp.vdot(
            fn(z, z, jnp.asarray(var), jnp.asarray(ls), True),
            jnp.asarray(Kbar)))(jnp.asarray(X))
        gx, gz, _, _ = kxz_kernel.kxz_vjp_plain(*ins, kind)
        np.testing.assert_allclose((gx + gz).numpy(), np.asarray(total),
                                   rtol=1e-10,
                                   atol=1e-10 * np.abs(total).max())


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("same", [False, True])
@pytest.mark.parametrize("ard", [False, True])
@pytest.mark.parametrize("kind", ["rbf", "matern32"])
def test_vjp_plain_matches_autograd_of_kxz_plain(kind, ard, same, dtype):
    """The closed form is the gradient autograd takes through the dense
    formula (K(Z, Z): one leaf on both sides, so the two parts add)."""
    np_dtype = np.float64 if dtype == torch.float64 else np.float32
    X, X2, ls, var, Kbar = _inputs(97, 41, 4, ard, same, np_dtype, seed=3)
    leaves = [torch.tensor(t, requires_grad=True) for t in (X, X2, ls, var)]
    if same:
        leaves[1] = leaves[0]
    K = kxz_kernel.kxz_plain(*leaves, kind=kind)
    K.backward(torch.as_tensor(Kbar))
    ins = [t.detach() for t in leaves]
    gx, gz, gl, gv = kxz_kernel.kxz_vjp_plain(*ins, torch.as_tensor(Kbar), kind)
    want_x = leaves[0].grad
    got_x = gx + gz if same else gx
    tol = 1e-12 if dtype == torch.float64 else 2e-5
    pairs = [(got_x, want_x), (gl, leaves[2].grad), (gv, leaves[3].grad)]
    if not same:
        pairs.append((gz, leaves[1].grad))
    for g, w in pairs:
        assert g.shape == w.shape and g.dtype == dtype
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=tol,
                                   atol=tol * float(w.abs().max()))


def _emulate(X, X2, ls, var, Kbar, kind):
    """csrc/kxz.cu's pullback in torch f32 ops, its tiles and fixed orders:
    pass 1's partial rows (a thread's 4 columns, then the 32 lanes in
    order) and columns (a thread's rows by row group, then the 8 warps in
    order) in the workspace's layout, var's by lane, butterfly and warp;
    pass 2's sums over the tiles (each of 8 warps a stride-8 share, then
    the warps in order), in double.  FMAs are a multiply
    and an add here, so this holds the decomposition, not the bits."""
    f32, f64 = torch.float32, torch.float64
    N, D = X.shape
    M = X2.shape[0]
    TM, TR = kxz_kernel.TILE_M, kxz_kernel.VJP_ROWS
    nct, nrg = -(-M // TM), -(-N // TR)
    Np, Mp = nrg * TR, nct * TM
    lsv = ls.reshape(-1).expand(D)

    def scaled(A, rows):
        out = torch.zeros(rows, D, dtype=f32)
        out[:A.shape[0]] = A / lsv
        nrm = torch.zeros(rows, dtype=f32)
        for d in range(D):
            nrm = nrm + out[:, d] * out[:, d]
        return out, nrm

    xs, xn = scaled(X, Np)
    zs, zn = scaled(X2, Mp)
    cross = torch.zeros(Np, Mp, dtype=f32)
    for d in range(D):
        cross = cross + xs[:, d, None] * zs[None, :, d]
    raw = xn[:, None] + zn[None, :] - 2.0 * cross
    d2 = raw.clamp_min(0.0)
    if kind == "rbf":
        phi = torch.exp(-0.5 * d2)
        dphi = -0.5 * phi
    else:
        s3 = np.float32(np.sqrt(3.0))
        r = torch.sqrt(d2 + 1e-36)
        e = torch.exp(-s3 * r)
        phi, dphi = (1.0 + s3 * r) * e, -1.5 * e
    kb = torch.zeros(Np, Mp, dtype=f32)
    kb[:N, :M] = Kbar
    W = torch.where(raw >= 0, kb * var * dphi, torch.zeros_like(raw))

    def row_sums(V):                          # -> [nct, Np]
        V = V.reshape(Np, nct, 32, 4)
        lane = ((V[..., 0] + V[..., 1]) + V[..., 2]) + V[..., 3]
        s = torch.zeros(Np, nct, dtype=f32)
        for l in range(32):
            s = s + lane[..., l]
        return s.T

    def col_sums(V):                          # -> [nrg, Mp]
        V = V.reshape(nrg, 8, 8, 4, Mp)       # block, row group, warp, row, col
        acc = torch.zeros(nrg, 8, Mp, dtype=f32)
        for grp in range(8):
            for j in range(4):
                acc = acc + V[:, grp, :, j]
        s = torch.zeros(nrg, Mp, dtype=f32)
        for w in range(8):
            s = s + acc[:, w]
        return s

    rowpart = torch.stack([row_sums(W)] + [row_sums(W * zs[None, :, d])
                                           for d in range(D)], 1)[..., :N]
    colpart = torch.stack([col_sums(W)] + [col_sums(W * xs[:, d, None])
                                           for d in range(D)], 1)[..., :M]
    assert rowpart.numel() == kxz_kernel.vjp_workspace(N, M, D, (1, 0, 0, 0))[0]
    assert colpart.numel() == kxz_kernel.vjp_workspace(N, M, D, (0, 1, 0, 0))[1]
    P = (kb * phi).reshape(nrg, 8, 8, 4, nct, 32, 4)
    acc = torch.zeros(nrg, 8, nct, 32, dtype=f32)
    for grp in range(8):
        for j in range(4):
            for e in range(4):
                acc = acc + P[:, grp, :, j, :, :, e]
    idx = torch.arange(32)
    for o in (16, 8, 4, 2, 1):
        acc = acc + acc[..., idx ^ o]
    varpart = torch.zeros(nrg, nct, dtype=f64)
    for w in range(8):
        varpart = varpart + acc[:, w, :, 0].double()

    def side(part, A, lim, ntiles):
        flat = part.reshape(-1)
        stride = (1 + D) * lim
        line = torch.arange(lim)

        def tiles(c):                         # warp w: tiles w, w + 8, ...
            tot = torch.zeros(lim, dtype=f64)
            for w in range(8):
                s = torch.zeros(lim, dtype=f64)
                for t in range(w, ntiles, 8):
                    s = s + flat[t * stride + c * lim + line].double()
                tot = tot + s
            return tot

        R = tiles(0)
        bar, term = [], torch.zeros(lim, D, dtype=f64)
        for d in range(D):
            S = tiles(1 + d)
            l = lsv[d]
            x = A[:, d] / l
            g = 2.0 * (x.double() * R - S)
            bar.append((g / l.double()).float())
            term[:, d] = g * x.double()
        return torch.stack(bar, 1), term.sum(0)

    Xb, tx = side(rowpart, X, N, nct)
    Zb, tz = side(colpart, X2, M, nrg)
    lb = -(tx + tz) / lsv.double()
    lb = lb.sum().reshape(ls.shape) if ls.numel() == 1 else lb.reshape(ls.shape)
    vb = varpart.reshape(-1).sum().reshape(var.shape)
    return Xb, Zb, lb.float(), vb.float()


@pytest.mark.parametrize("kind", ["rbf", "matern32"])
@pytest.mark.parametrize("N, M, D, ard", [(301, 37, 3, True), (257, 129, 4, False),
                                          (1, 1, 4, True), (130, 77, 11, False),
                                          (40, 9, 130, True)])
def test_tile_emulation_adds_up_to_the_closed_form(kind, N, M, D, ard):
    """The kernel's tiles and two-pass sums reproduce kxz_vjp_plain at f32
    tolerance (3e-5 of each gradient's largest entry), and the same bits on
    a second run."""
    X, X2, ls, var, Kbar = (torch.as_tensor(t) for t in
                            _inputs(N, M, D, ard, False, np.float32, seed=11))
    got = _emulate(X, X2, ls, var, Kbar, kind)
    again = _emulate(X, X2, ls, var, Kbar, kind)
    want = kxz_kernel.kxz_vjp_plain(X, X2, ls, var, Kbar, kind)
    for g, a, w in zip(got, again, want):
        assert g.shape == w.shape
        assert torch.equal(g.view(torch.int32), a.view(torch.int32))
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=3e-5 * float(w.abs().max()))


class _OnTheCard:
    """Stands in for a CUDA tensor for the launcher's checks: its device
    reads as the card, its data is a CPU tensor's."""

    def __init__(self, t):
        self.t = t
        self.device = torch.device("cuda", 0)
        self.dtype, self.shape, self.ndim = t.dtype, t.shape, t.ndim
        self.requires_grad = False

    def is_contiguous(self):
        return self.t.is_contiguous()

    def data_ptr(self):
        return self.t.data_ptr()

    def numel(self):
        return self.t.numel()

    def stride(self, i):
        return self.t.stride(i)

    def reshape(self, *shape):
        return _OnTheCard(self.t.reshape(*shape))

    def expand(self, *shape):
        return _OnTheCard(self.t.expand(*shape))


def _launch(N, M, D, ard, same, needs, code=0):
    X, X2, ls, var, Kbar = (torch.as_tensor(t) for t in
                            _inputs(N, M, D, ard, same, np.float32))
    ins = [_OnTheCard(t) for t in (X, X2, ls, var, Kbar)]
    if same:
        ins[1] = ins[0]
    calls, allocated = [], []

    class Lib:
        def mgp_kxz_vjp(self, *args):
            calls.append(args)
            return code

    real_empty = torch.empty

    def cpu_empty(*a, device=None, **kw):
        out = real_empty(*a, **kw)
        allocated.append(out)
        return out

    def refuse(*a, **kw):
        raise AssertionError("the plain version ran for a CUDA tensor")

    with mock.patch.object(_native, "library", Lib), \
            mock.patch.object(_native, "stream_ptr", lambda device: 77), \
            mock.patch.object(kxz_kernel.torch, "empty", cpu_empty), \
            mock.patch.object(kxz_kernel, "kxz_plain", refuse), \
            mock.patch.object(kxz_kernel, "kxz_vjp_plain", refuse):
        out = kxz_kernel.kxz_vjp(*ins[:4], ins[4], kind="matern32",
                                 needs=needs)
    return ins, calls, allocated, out


@pytest.mark.parametrize("needs", SUBSETS)
@pytest.mark.parametrize("N, M, D, ard, same", [(301, 37, 3, True, False),
                                                (1000, 2100, 4, False, False),
                                                (200, 200, 4, False, True),
                                                (40, 9, 11, True, False),
                                                (40, 9, 130, True, False)])
def test_vjp_launcher_passes_arguments_and_workspace(N, M, D, ard, same,
                                                     needs):
    """The entry point gets (X, X2, l, var, Kbar, rowpart, colpart,
    blockpart, X_bar, X2_bar, l_bar, var_bar, N, M, D, l's stride, kind,
    needs, stream): the outputs asked for (null for the others) in their
    inputs' shapes, rowpart [ceil(M / 128), 1 + D, N] f32 when X or l is
    asked for, colpart [ceil(N / 256), 1 + D, M] when X2 or l is, blockpart
    f64 of ceil(N / 256) ceil(M / 128) + max(1, ceil((N + M) / 32)) D + 1,
    and the launch is counted once."""
    before = kxz_kernel.kxz_vjp.launches
    ins, calls, allocated, out = _launch(N, M, D, ard, same, needs)
    (args,) = calls
    by_ptr = {t.data_ptr(): t for t in allocated}
    for a, t in zip(args[:5], ins):
        assert a == t.data_ptr()
    rowpart, colpart, blockpart = (by_ptr[p] for p in args[5:8])
    nct, nrg = -(-M // 128), -(-N // 256)
    nsum = max(1, -(-(N + M) // 32))
    need_x, need_z, need_l, need_v = needs
    assert rowpart.dtype == colpart.dtype == torch.float32
    assert rowpart.numel() == (nct * (1 + D) * N if need_x or need_l else 0)
    assert colpart.numel() == (nrg * (1 + D) * M if need_z or need_l else 0)
    assert blockpart.dtype == torch.float64
    assert blockpart.numel() == nrg * nct + nsum * D + 1
    shapes = ((N, D), (M, D), ins[2].shape, ins[3].shape)
    for ptr, n, o, shape in zip(args[8:12], needs, out, shapes):
        if n:
            assert by_ptr[ptr].data_ptr() == o.data_ptr() and o.shape == shape
            assert o.dtype == torch.float32
        else:
            assert ptr == 0 and o is None
    bits = sum(b for b, n in zip((1, 2, 4, 8), needs) if n)
    assert args[12:] == (N, M, D, 1 if ard and D > 1 else 0, 1, bits, 77)
    assert kxz_kernel.kxz_vjp.launches == before + 1
    kxz_kernel.kxz_vjp.launches = before


def test_vjp_launcher_raises_on_a_failed_launch():
    """A CUDA error from the entry point raises; nothing falls back to the
    plain version (kxz_plain and kxz_vjp_plain would fail the test)."""
    with pytest.raises(RuntimeError, match="kxz_vjp: CUDA error 700"):
        _launch(301, 37, 3, True, False, (True, True, True, True), code=700)


def test_vjp_launcher_checks_kbar():
    X = _OnTheCard(torch.zeros(5, 2))
    Z = _OnTheCard(torch.zeros(3, 2))
    l, v = _OnTheCard(torch.tensor(0.5)), _OnTheCard(torch.tensor(1.0))
    with pytest.raises(ValueError, match=r"Kbar must be \[5, 3\]"):
        kxz_kernel.kxz_vjp(X, Z, l, v, _OnTheCard(torch.zeros(3, 5)))
    with pytest.raises(TypeError):
        kxz_kernel.kxz_vjp(X, Z, l, v,
                           _OnTheCard(torch.zeros(5, 3, dtype=torch.float64)))


@pytest.mark.parametrize("needs", [(True, False, True, True),
                                   (True, True, True, True),
                                   (False, False, False, True)])
def test_autograd_backward_launches_the_pullback(needs):
    """_Kxz.backward hands the saved inputs, the cotangent and
    needs_input_grad to kxz_vjp, and returns its gradients; it never
    recomputes the dense formula."""
    ins = [torch.randn(6, 2), torch.randn(4, 2), torch.tensor(0.5),
           torch.tensor(0.9)]
    Kbar = torch.randn(6, 4)
    seen = []

    def fake_vjp(X, X2, l, v, Kb, *, kind, needs):
        seen.append((X, X2, l, v, Kb, kind, needs))
        return tuple(torch.full_like(t, i) if n else None
                     for i, (t, n) in enumerate(zip((X, X2, l, v), needs)))

    def refuse(*a, **kw):
        raise AssertionError("the dense formula ran in the backward")

    class Ctx:
        saved_tensors = tuple(ins)
        needs_input_grad = (*needs, False)
        kind = "rbf"

    with mock.patch.object(kxz_kernel, "kxz_vjp", fake_vjp), \
            mock.patch.object(kxz_kernel, "kxz_plain", refuse):
        grads = kxz_kernel._Kxz.backward(Ctx, Kbar)
    ((X, X2, l, v, Kb, kind, got_needs),) = seen
    assert all(a is b for a, b in zip((X, X2, l, v), ins))
    assert torch.equal(Kb, Kbar) and kind == "rbf" and got_needs == needs
    assert len(grads) == 5 and grads[4] is None
    for i, (g, n) in enumerate(zip(grads, needs)):
        assert (g is None) == (not n)
        if n:
            assert torch.equal(g, torch.full_like(ins[i], i))
