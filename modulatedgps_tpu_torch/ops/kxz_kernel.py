"""K(X, X2) for the stationary kernels and its pullback: the CUDA kernels
and their plain versions.

Replaces modulatedgps_tpu/ops/pallas_kernels.py:_kxz_pallas (reached there
through rbf_kxz / matern32_kxz) and its custom_vjp backward, the gradient of
the dense formula (jax.vjp of _rbf_xla / _matern32_xla,
pallas_kernels.py:155-158), which XLA fuses under jit.  The kernels are
csrc/kxz.cu.  On the H100 both are bound by device memory: the forward by
the N*M*4-byte store of the result, which it writes with 16-byte row
stores from scaled X and X2 rows staged once a tile (the cross term in fp32
registers: D is a handful of FMAs; no TF32, no tensor cores); the pullback
by one read of the cotangent K_bar, recomputing K in registers, with partial
row and column sums in a workspace added in a fixed order by a second
launch.  The signal variance is folded into the epilogue; a scalar
lengthscale is read in place for every coordinate.

``kxz`` takes the plain version only for CPU tensors; for CUDA tensors it
launches the kernel or raises.  On the card ``kxz`` is an autograd
Function: the forward launches the forward kernel, the backward the
pullback kernels, for the inputs that need a gradient.  Every forward launch
adds one to ``kxz.launches``, every pullback launch one to
``kxz_vjp.launches``.  ``kxz_vjp_plain`` is the pullback's closed form in
torch ops, the reference the tests and chip_smoke.py hold the kernel to.
"""
from __future__ import annotations

import math

import torch

from .. import _native
from ..utils.profiling import span

__all__ = ["kxz", "kxz_launch", "kxz_plain", "kxz_vjp", "kxz_vjp_plain",
           "vjp_workspace", "check_launch_args", "KINDS", "NEEDS"]

KINDS = {"rbf": 0, "matern32": 1}
# The pullback's outputs, as csrc/kxz.cu's needs bits: X, X2, lengthscales,
# variance.
NEEDS = (1, 2, 4, 8)
# csrc/kxz.cu's pullback tiles: TILE_M columns by VJP_ROWS rows a pass-1
# block, SUM_LINES rows or columns a pass-2 block.
TILE_M, VJP_ROWS, SUM_LINES = 128, 256, 32


def kxz_plain(X, X2, lengthscales, variance, *, kind: str = "rbf"):
    """Dense formula mirroring pallas_kernels._rbf_xla / _matern32_xla:
    |x|^2 + |z|^2 - 2 x.z on the scaled inputs, clamped at 0."""
    Xs, Zs = X / lengthscales, X2 / lengthscales
    d2 = ((Xs ** 2).sum(-1)[:, None] + (Zs ** 2).sum(-1)[None, :]
          - 2.0 * (Xs @ Zs.T))
    d2 = d2.clamp_min(0.0)
    if kind == "rbf":
        return variance * torch.exp(-0.5 * d2)
    r = torch.sqrt(d2 + 1e-36)
    s3 = math.sqrt(3.0)
    return variance * (1.0 + s3 * r) * torch.exp(-s3 * r)


def kxz_vjp_plain(X, X2, lengthscales, variance, Kbar, kind="rbf",
                  needs=(True, True, True, True)):
    """The closed form of the gradient of kxz_plain for the cotangent Kbar
    [N, M]: (X_bar, X2_bar, lengthscales_bar, variance_bar), each in its
    input's shape, None where ``needs`` is False.

    W = Kbar var phi'(d2) [raw d2 >= 0] (torch's clamp_min convention),
    R = W 1, C = W^T 1, xs_bar = 2 (xs R - W zs), zs_bar = 2 (zs C - W^T xs),
    X_bar = xs_bar / l, l_bar = -(sum_a xs_bar xs + sum_b zs_bar zs) / l
    summed to l's shape, var_bar = sum Kbar phi."""
    ls = lengthscales.reshape(-1)
    Xs, Zs = X / ls, X2 / ls
    raw = ((Xs ** 2).sum(-1)[:, None] + (Zs ** 2).sum(-1)[None, :]
           - 2.0 * (Xs @ Zs.T))
    d2 = raw.clamp_min(0.0)
    if kind == "rbf":
        phi = torch.exp(-0.5 * d2)
        dphi = -0.5 * phi
    else:
        s3 = math.sqrt(3.0)
        r = torch.sqrt(d2 + 1e-36)
        e = torch.exp(-s3 * r)
        phi = (1.0 + s3 * r) * e
        dphi = -1.5 * e
    W = torch.where(raw >= 0, Kbar * variance * dphi, torch.zeros_like(raw))
    need_x, need_z, need_l, need_v = needs
    xs_bar = zs_bar = None
    if need_x or need_l:
        xs_bar = 2.0 * (Xs * W.sum(1, keepdim=True) - W @ Zs)
    if need_z or need_l:
        zs_bar = 2.0 * (Zs * W.sum(0)[:, None] - W.T @ Xs)
    l_bar = None
    if need_l:
        l_bar = -((xs_bar * Xs).sum(0) + (zs_bar * Zs).sum(0)) / ls
        l_bar = l_bar.sum().reshape(lengthscales.shape) \
            if lengthscales.numel() == 1 else l_bar.reshape(lengthscales.shape)
    return (xs_bar / ls if need_x else None,
            zs_bar / ls if need_z else None,
            l_bar,
            (Kbar * phi).sum().reshape(variance.shape) if need_v else None)


def check_launch_args(X, X2, lengthscales, variance):
    """Checks for the CUDA launch; returns (lengthscales [D], variance [1])
    as fp32 views on X's device: a scalar lengthscale is expanded to D with
    stride 0 (no copy; the kernels read it in place)."""
    _native.require("kxz X", X, torch.float32, X.device)
    _native.require("kxz X2", X2, torch.float32, X.device)
    _native.require("kxz lengthscales", lengthscales, torch.float32, X.device)
    _native.require("kxz variance", variance, torch.float32, X.device)
    D = X.shape[1]
    if lengthscales.numel() not in (1, D):
        raise ValueError(f"kxz: lengthscales must be a scalar or [{D}], "
                         f"got {tuple(lengthscales.shape)}")
    if variance.numel() != 1:
        raise ValueError("kxz: variance must be a scalar")
    return lengthscales.reshape(-1).expand(D), variance.reshape(1)


def _check_inputs(X, X2, kind):
    if kind not in KINDS:
        raise ValueError(f"kxz: unknown kind {kind!r}; have {list(KINDS)}")
    if X.ndim != 2 or X2.ndim != 2 or X.shape[1] != X2.shape[1]:
        raise ValueError(f"kxz: expected [N, D] and [M, D], got "
                         f"{tuple(X.shape)} and {tuple(X2.shape)}")


def kxz(X, X2, lengthscales, variance, *, kind: str = "rbf"):
    """K [N, M] = variance * phi(|x/l - z/l|^2) for X [N, D], X2 [M, D]."""
    _check_inputs(X, X2, kind)
    if X.device.type == "cpu":
        return kxz_plain(X, X2, lengthscales, variance, kind=kind)
    if X.device.type != "cuda":
        raise ValueError(f"kxz: unsupported device {X.device}")
    return _Kxz.apply(X, X2, lengthscales, variance, kind)


class _Kxz(torch.autograd.Function):
    @staticmethod
    def forward(ctx, X, X2, lengthscales, variance, kind):
        ctx.save_for_backward(X, X2, lengthscales, variance)
        ctx.kind = kind
        with span("mgp.kxz.fwd", X, "op"):
            return kxz_launch(X, X2, lengthscales, variance, kind=kind)

    @staticmethod
    def backward(ctx, Kbar):
        need = ctx.needs_input_grad[:4]
        with span("mgp.kxz.bwd", Kbar, "op"):
            grads = kxz_vjp(*ctx.saved_tensors, Kbar.contiguous(),
                            kind=ctx.kind, needs=need)
        return (*grads, None)


def kxz_launch(X, X2, lengthscales, variance, *, kind: str = "rbf"):
    """The raw launcher: X [N, D], X2 [M, D] fp32 on the card -> [N, M]."""
    ls, var = check_launch_args(X, X2, lengthscales, variance)
    N, D = X.shape
    M = X2.shape[0]
    out = torch.empty((N, M), dtype=torch.float32, device=X.device)
    code = _native.library().mgp_kxz(
        X.data_ptr(), X2.data_ptr(), ls.data_ptr(), var.data_ptr(),
        out.data_ptr(), N, M, D, ls.stride(0), KINDS[kind],
        _native.stream_ptr(X.device))
    _native.check(code, "kxz")
    kxz.launches += 1
    return out


def vjp_workspace(N, M, D, needs):
    """Element counts of the pullback's workspace: (rowpart f32, colpart
    f32, blockpart f64).  rowpart [ceil(M / TILE_M), 1 + D, N] holds pass
    1's partial row sums (asked for X or l), colpart [ceil(N / VJP_ROWS),
    1 + D, M] its column sums (asked for X2 or l); blockpart the blocks'
    variance partials, pass 2's lengthscale partials and the counter."""
    need_x, need_z, need_l, _ = needs
    nct, nrg = -(-M // TILE_M), -(-N // VJP_ROWS)
    nsum = max(1, -(-(N + M) // SUM_LINES))
    return (nct * (1 + D) * N if need_x or need_l else 0,
            nrg * (1 + D) * M if need_z or need_l else 0,
            nrg * nct + nsum * D + 1)


def kxz_vjp(X, X2, lengthscales, variance, Kbar, *, kind: str = "rbf",
            needs=(True, True, True, True)):
    """The pullback kernels on the card: the gradients of kxz for the
    cotangent Kbar [N, M], (X_bar, X2_bar, lengthscales_bar, variance_bar)
    in their inputs' shapes, None where ``needs`` is False."""
    _check_inputs(X, X2, kind)
    ls, var = check_launch_args(X, X2, lengthscales, variance)
    _native.require("kxz_vjp Kbar", Kbar, torch.float32, X.device)
    N, D = X.shape
    M = X2.shape[0]
    if Kbar.shape != (N, M):
        raise ValueError(f"kxz_vjp: Kbar must be [{N}, {M}], got "
                         f"{tuple(Kbar.shape)}")
    needs = tuple(bool(n) for n in needs)
    if not any(needs):
        return (None,) * 4
    dev = X.device
    n_row, n_col, n_block = vjp_workspace(N, M, D, needs)
    rowpart = torch.empty(n_row, dtype=torch.float32, device=dev)
    colpart = torch.empty(n_col, dtype=torch.float32, device=dev)
    blockpart = torch.empty(n_block, dtype=torch.float64, device=dev)
    outs = [torch.empty(shape, dtype=torch.float32, device=dev) if n else None
            for n, shape in zip(needs, ((N, D), (M, D),
                                        (lengthscales.numel(),), (1,)))]
    code = _native.library().mgp_kxz_vjp(
        X.data_ptr(), X2.data_ptr(), ls.data_ptr(), var.data_ptr(),
        Kbar.data_ptr(), rowpart.data_ptr(), colpart.data_ptr(),
        blockpart.data_ptr(), *(0 if t is None else t.data_ptr() for t in outs),
        N, M, D, ls.stride(0), KINDS[kind],
        sum(bit for bit, n in zip(NEEDS, needs) if n), _native.stream_ptr(dev))
    _native.check(code, "kxz_vjp")
    kxz_vjp.launches += 1
    X_bar, X2_bar, l_bar, v_bar = outs
    return (X_bar, X2_bar,
            None if l_bar is None else l_bar.reshape(lengthscales.shape),
            None if v_bar is None else v_bar.reshape(variance.shape))


kxz.launches = 0
kxz_vjp.launches = 0
