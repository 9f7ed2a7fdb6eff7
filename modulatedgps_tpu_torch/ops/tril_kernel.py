"""The q_sqrt terms of the conditional: B = A^T tril L_k from bf16 operands.
The CUDA kernels for B16 = bf16(B), for B in f32, for dL and dA, and their
plain versions.

Replaces modulatedgps_tpu/ops/pallas_tril.py:_k_fwd_b16 (forward) and
_k_dl_g / _k_da_g (backward), reached there through atl_sq_colsum (the
diagonal variance sum_m' B^2), and _k_fwd (forward) and _k_dl / _k_da
(backward), reached through atl_matmul (the f32 B of the full covariance).
The kernels are csrc/tril_fwd.cu (both forwards, one kernel templated on
the output type) and csrc/tril_bwd.cu (both backward pairs, templated on
the source of W).  On the H100 each is tensor-core bound (K*N*M^2/2 =
5.5e11 multiply-adds a layer at M=4096, N=8192, K=8), so each holds fp32
accumulators over the whole contraction, visits only the tiles on or below
the diagonal, and zeroes L's strictly-upper entries before they reach the
tensor cores.  All four are Hopper's shape (TMA loads into a ring of
shared-memory stages, wgmma from two warpgroups, a persistent grid; the
plumbing is csrc/hopper.cuh).  Their tensor maps need 16-byte row
strides: the wrappers pad A16 (and G) to a multiple of 8 columns and L16
to a multiple of 8 rows and columns, and B16 / W16 to a multiple of 8
columns, with zeros, where N or M is not one (a shape rule of the kernels,
which the main path's shapes already meet).  The square-sum's backward
kernels form W = bf16(B16 * G) on chip after each tile lands (G = 2 * the
cotangent of the square-sum), in the registers wgmma reads it from, so no
W array reaches device memory; atl_matmul's read W16 = bf16(dB).

As in JAX, the bf16 casts happen in ``atl_sq_colsum`` and ``atl_matmul``,
and the square-sum over m' runs outside the kernel: B16 stays the forward
kernel's output because the backward kernels read it.

``atl_sq_colsum(A, L, split=True)`` takes the same function at a higher
precision, which SMGP asks for on both its layers and SMGPModified on its
assignment layer (models/smgp.py): at tau = 1e-2 the mixture weights are
one-hot to f32 rounding, and one bf16 pass in a layer's variance moves the
float32 assignment gradients 2e-2 to 7e-2 of their scale off float64
(tests/test_torch_f32_assign_grad.py).  Its forward (``tril_sq_fwd_split``:
the same kernel run as three bf16 passes, A_hi L_hi + A_lo L_hi + A_hi
L_lo, into one fp32 accumulator) stores B in f32 and sums its squares from
the fp32 accumulators; its backward splits W = B G into W_hi + W_lo and
runs dA as the 3-pass sum on ``tril_da`` (the three passes as 3K latents:
[L_hi; L_lo; L_hi] against [W_hi; W_hi; W_lo]) and dL in one pass
(``tril_dl`` on W_hi): the cheapest split found that keeps every
assignment leaf within 5e-3 of float64 there (a one-pass dA does not).

Each wrapper (``tril_sq_fwd``, ``tril_fwd_f32``, ``tril_sq_fwd_split``,
``tril_dl``, ``tril_da``, ``tril_sq_dl``, ``tril_sq_da``) takes its plain
version only for CPU tensors; for CUDA tensors it launches the kernel or
raises.  Every launch adds one to the wrapper's ``launches``.
"""
from __future__ import annotations

import torch

from .. import _native
from ..utils.profiling import span

TILE_P = 256   # m' columns of the product's output tile: part's middle axis

__all__ = ["tril_sq_fwd", "tril_sq_fwd_plain", "tril_fwd_f32",
           "tril_fwd_f32_plain", "tril_sq_fwd_split", "tril_sq_fwd_split_plain",
           "split_bf16", "tril_dl", "tril_dl_plain", "tril_da",
           "tril_da_plain", "tril_sq_dl", "tril_sq_dl_plain", "tril_sq_da",
           "tril_sq_da_plain", "atl_sq_colsum", "atl_matmul",
           "check_launch_args", "check_bwd_launch_args"]


def tril_fwd_f32_plain(A16, L16):
    """A^T tril(L) with fp32 accumulation: [M, N], [K, M, M] -> [K, N, M] f32."""
    return A16.float().T @ torch.tril(L16.float())


def tril_sq_fwd_plain(A16, L16):
    """bf16(A^T tril(L)) with fp32 accumulation: [M, N], [K, M, M] -> [K, N, M]."""
    return tril_fwd_f32_plain(A16, L16).to(torch.bfloat16)


def tril_sq_fwd_split_plain(A2, L2):
    """The 3-pass split product with fp32 accumulation and its row square
    sums: A2 [2, M, N] (A_hi, A_lo), L2 [2K, M, M] (L_hi, L_lo) -> B =
    A_hi^T tril(L_hi) + A_lo^T tril(L_hi) + A_hi^T tril(L_lo) [K, N, M] f32
    and extra = sum_m' B^2 [K, N] f32."""
    K = L2.shape[0] // 2
    B = (tril_fwd_f32_plain(A2[0], L2[:K]) + tril_fwd_f32_plain(A2[1], L2[:K])
         + tril_fwd_f32_plain(A2[0], L2[K:]))
    return B, B.square().sum(-1)


def split_bf16(x, out):
    """Write x's bf16 split into out[0] (hi = bf16(x)) and out[1] (lo =
    bf16(x - hi)); returns out."""
    out[0].copy_(x)
    torch.sub(x, out[0], out=out[1])
    return out


def _scaled(B16, G):
    """W = bf16(f32(B16) * G), the rounding order of the TPU kernels."""
    return (B16.float() * G[:, :, None]).to(torch.bfloat16)


def tril_dl_plain(A16, W16):
    """dL[k] = tril(A16 W16_k) with fp32 accumulation: [M, N], [K, N, M]
    -> [K, M, M] fp32."""
    return torch.tril(A16.float() @ W16.float())


def tril_da_plain(L16, W16):
    """dA = sum_k tril(L16_k) W16_k^T with fp32 accumulation, as one
    [M, K*M] x [K*M, N] product: [K, M, M], [K, N, M] -> [M, N] fp32."""
    K, M, _ = L16.shape
    Lcat = torch.tril(L16.float()).permute(1, 0, 2).reshape(M, K * M)
    Wcat = W16.float().transpose(1, 2).reshape(K * M, -1)
    return Lcat @ Wcat


def tril_sq_dl_plain(A16, B16, G):
    """tril_dl_plain with W = bf16(B16 G): [M, N], [K, N, M], [K, N] ->
    [K, M, M] fp32."""
    return tril_dl_plain(A16, _scaled(B16, G))


def tril_sq_da_plain(L16, B16, G):
    """tril_da_plain with W = bf16(B16 G): [K, M, M], [K, N, M], [K, N] ->
    [M, N] fp32."""
    return tril_da_plain(L16, _scaled(B16, G))


def check_launch_args(A16, L16, what="tril_sq_fwd"):
    _native.require(f"{what} A16", A16, torch.bfloat16, A16.device)
    _native.require(f"{what} L16", L16, torch.bfloat16, A16.device)


def check_bwd_launch_args(what, X16, B16, G=None):
    """The backward kernels' operands: A16 or L16, then B16 (with G, the
    square-sum's scaling) or W16 (G=None)."""
    _native.require(f"{what} operand", X16, torch.bfloat16, X16.device)
    _native.require(f"{what} {'W16' if G is None else 'B16'}", B16,
                    torch.bfloat16, X16.device)
    if G is not None:
        _native.require(f"{what} G", G, torch.float32, X16.device)


def _check_device(what, t):
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: unsupported device {t.device}")
    return t.device.type == "cuda"


def _check_fwd_shapes(what, A16, L16):
    if A16.ndim != 2 or L16.ndim != 3 or L16.shape[1:] != (A16.shape[0],) * 2:
        raise ValueError(f"{what}: expected [M, N] and [K, M, M], got "
                         f"{tuple(A16.shape)} and {tuple(L16.shape)}")
    return _check_device(what, A16)


def _pad8(t, dims):
    """t with its last ``dims`` dimensions padded with zeros to multiples of
    8; t itself where they already are."""
    pad = []
    for size in reversed(t.shape[t.ndim - dims:]):
        pad += [0, -size % 8]
    return torch.nn.functional.pad(t, pad) if any(pad) else t


def _tma_operands(A16, L16):
    """(A16, L16) with row strides the forward kernel's TMA can take: A16
    [M, N] padded with zero columns to a multiple of 8, L16 [K, M, M] with
    zero rows and columns to a multiple of 8, each only where needed."""
    return _pad8(A16, 1), _pad8(L16, 2)


def _tma_bwd_operands(X16, B16, G=None):
    """The backward kernels' operands with TMA row strides: X16 is A16 [M,
    N] (padded as the forward's A) or L16 [K, M, M] (as the forward's L);
    B16 / W16 [K, N, M] get zero columns to a multiple of 8 and G [K, N]
    too, each only where needed."""
    return (_pad8(X16, X16.ndim - 1), _pad8(B16, 1),
            None if G is None else _pad8(G, 1))


def _fwd(what, entry, out_dtype, A16, L16):
    """Launch one of the two forward entry points: -> [K, N, M] out_dtype."""
    check_launch_args(A16, L16, what)
    M, N = A16.shape
    K = L16.shape[0]
    A16, L16 = _tma_operands(A16, L16)
    B = torch.empty((K, N, M), dtype=out_dtype, device=A16.device)
    code = getattr(_native.library(), entry)(
        A16.data_ptr(), L16.data_ptr(), B.data_ptr(), M, N, K, A16.shape[1],
        L16.shape[-1], _native.stream_ptr(A16.device))
    _native.check(code, what)
    return B


def tril_sq_fwd(A16, L16):
    """B16[k, n, m'] = bf16(sum_{m >= m'} A16[m, n] L16[k, m, m'])."""
    if not _check_fwd_shapes("tril_sq_fwd", A16, L16):
        return tril_sq_fwd_plain(A16, L16)
    B16 = _fwd("tril_sq_fwd", "mgp_tril_fwd", torch.bfloat16, A16, L16)
    tril_sq_fwd.launches += 1
    return B16


def tril_fwd_f32(A16, L16):
    """B[k, n, m'] = sum_{m >= m'} A16[m, n] L16[k, m, m'] in f32."""
    if not _check_fwd_shapes("tril_fwd_f32", A16, L16):
        return tril_fwd_f32_plain(A16, L16)
    B = _fwd("tril_fwd_f32", "mgp_tril_fwd_f32", torch.float32, A16, L16)
    tril_fwd_f32.launches += 1
    return B


def tril_sq_fwd_split(A2, L2):
    """(B, extra): B[k, n, m'] = sum_{m >= m'} (A_hi[m, n] L_hi[k, m, m'] +
    A_lo[m, n] L_hi[k, m, m'] + A_hi[m, n] L_lo[k, m, m']) in f32 and
    extra[k, n] = sum_m' B[k, n, m']^2 from the fp32 sums, from A2 [2, M, N]
    bf16 (A_hi, A_lo) and L2 [2K, M, M] bf16 (L_hi, L_lo; upper triangles
    ignored)."""
    if (A2.ndim != 3 or A2.shape[0] != 2 or L2.ndim != 3
            or L2.shape[0] % 2 or L2.shape[1:] != (A2.shape[1],) * 2):
        raise ValueError(f"tril_sq_fwd_split: expected [2, M, N] and [2K, M, M], "
                         f"got {tuple(A2.shape)} and {tuple(L2.shape)}")
    if not _check_device("tril_sq_fwd_split", A2):
        return tril_sq_fwd_split_plain(A2, L2)
    check_launch_args(A2, L2, "tril_sq_fwd_split")
    _, M, N = A2.shape
    K = L2.shape[0] // 2
    A2, L2 = _tma_operands(A2, L2)
    B = torch.empty((K, N, M), dtype=torch.float32, device=A2.device)
    part = torch.empty((K, -(-M // TILE_P), N), dtype=torch.float32,
                       device=A2.device)
    extra = torch.empty((K, N), dtype=torch.float32, device=A2.device)
    code = _native.library().mgp_tril_fwd_split(
        A2.data_ptr(), L2.data_ptr(), B.data_ptr(), part.data_ptr(),
        extra.data_ptr(), M, N, K, A2.shape[-1], L2.shape[-1],
        _native.stream_ptr(A2.device))
    _native.check(code, "tril_sq_fwd_split")
    tril_sq_fwd_split.launches += 1
    return B, extra


def _check_bwd_shapes(what, operand, X16, B16, G=None):
    """(K, N, M) of B16 or W16 [K, N, M], checked against the operand (A16
    [M, N] or L16 [K, M, M]) and, where given, G [K, N]."""
    K, N, M = B16.shape if B16.ndim == 3 else (-1, -1, -1)
    want = {"A16": (M, N), "L16": (K, M, M)}[operand]
    if K < 0 or X16.shape != want or (G is not None and G.shape != (K, N)):
        raise ValueError(f"{what}: expected B16 / W16 [K, N, M], {operand} "
                         f"{'[M, N]' if operand == 'A16' else '[K, M, M]'} "
                         f"and G [K, N], got {tuple(B16.shape)}, "
                         f"{tuple(X16.shape)} and "
                         f"{None if G is None else tuple(G.shape)}")
    return K, N, M


def _dl(what, entry, A16, B16, G=None):
    """Launch a dL entry point: -> [K, M, M] fp32, exactly lower-triangular."""
    check_bwd_launch_args(what, A16, B16, G)
    K, N, M = B16.shape
    A16, B16, G = _tma_bwd_operands(A16, B16, G)
    dL = torch.empty((K, M, M), dtype=torch.float32, device=A16.device)
    args = () if G is None else (G.data_ptr(),)
    code = getattr(_native.library(), entry)(
        A16.data_ptr(), B16.data_ptr(), *args, dL.data_ptr(), M, N, K,
        A16.shape[1], B16.shape[2], _native.stream_ptr(A16.device))
    _native.check(code, what)
    return dL


def _da(what, entry, L16, B16, G=None):
    """Launch a dA entry point: -> [M, N] fp32."""
    check_bwd_launch_args(what, L16, B16, G)
    K, N, M = B16.shape
    L16, B16, G = _tma_bwd_operands(L16, B16, G)
    dA = torch.empty((M, N), dtype=torch.float32, device=L16.device)
    args = () if G is None else (G.data_ptr(),)
    lds = (L16.shape[2],) if G is None else (L16.shape[2], G.shape[1])
    code = getattr(_native.library(), entry)(
        L16.data_ptr(), B16.data_ptr(), *args, dA.data_ptr(), M, N, K, *lds,
        _native.stream_ptr(L16.device))
    _native.check(code, what)
    return dA


def tril_dl(A16, W16):
    """dL[k, m, m'] = sum_n A16[m, n] W16[k, n, m'] for m >= m', exactly 0
    above the diagonal: -> [K, M, M] fp32 (atl_matmul's dL)."""
    _check_bwd_shapes("tril_dl", "A16", A16, W16)
    if not _check_device("tril_dl", A16):
        return tril_dl_plain(A16, W16)
    dL = _dl("tril_dl", "mgp_tril_dl_w", A16, W16)
    tril_dl.launches += 1
    return dL


def tril_da(L16, W16):
    """dA[m, n] = sum_k sum_{m' <= m} L16[k, m, m'] W16[k, n, m'] (L16's
    upper triangle ignored): -> [M, N] fp32 (atl_matmul's dA)."""
    _check_bwd_shapes("tril_da", "L16", L16, W16)
    if not _check_device("tril_da", L16):
        return tril_da_plain(L16, W16)
    dA = _da("tril_da", "mgp_tril_da_w", L16, W16)
    tril_da.launches += 1
    return dA


def tril_sq_dl(A16, B16, G):
    """dL[k, m, m'] = sum_n A16[m, n] bf16(B16[k, n, m'] G[k, n]) for
    m >= m', exactly 0 above the diagonal: -> [K, M, M] fp32."""
    _check_bwd_shapes("tril_sq_dl", "A16", A16, B16, G)
    if not _check_device("tril_sq_dl", A16):
        return tril_sq_dl_plain(A16, B16, G)
    dL = _dl("tril_sq_dl", "mgp_tril_dl", A16, B16, G)
    tril_sq_dl.launches += 1
    return dL


def tril_sq_da(L16, B16, G):
    """dA[m, n] = sum_k sum_{m' <= m} L16[k, m, m'] bf16(B16[k, n, m']
    G[k, n]) (L16's upper triangle ignored): -> [M, N] fp32."""
    _check_bwd_shapes("tril_sq_da", "L16", L16, B16, G)
    if not _check_device("tril_sq_da", L16):
        return tril_sq_da_plain(L16, B16, G)
    dA = _da("tril_sq_da", "mgp_tril_da", L16, B16, G)
    tril_sq_da.launches += 1
    return dA


tril_sq_fwd.launches = 0
tril_fwd_f32.launches = 0
tril_sq_fwd_split.launches = 0
tril_dl.launches = 0
tril_da.launches = 0
tril_sq_dl.launches = 0
tril_sq_da.launches = 0


def _split_operands(A, L):
    """A2 = [A_hi; A_lo] [2, M, N] and L3 = [L_hi; L_lo; L_hi] [3K, M, M]
    bf16: the forward's operands and the split dA's."""
    K, M, _ = L.shape
    A2 = split_bf16(A, torch.empty((2, *A.shape), dtype=torch.bfloat16,
                                   device=A.device))
    L3 = torch.empty((3 * K, M, M), dtype=torch.bfloat16, device=L.device)
    split_bf16(L, L3[:2 * K].view(2, K, M, M))
    L3[2 * K:].copy_(L3[:K])
    return A2, L3


class _AtlSqColsum(torch.autograd.Function):
    """pallas_tril.atl_sq_colsum's custom VJP (:561-597), in one bf16 pass
    or in the 3-pass split (``split``).

    One pass: the forward keeps (A16, L16, B16); the backward scales by G =
    2 gbar inside the dL / dA kernels (#8/#9).  The split: the forward keeps
    (A_hi, L3, B in f32); the backward forms W = B G in f32, splits it into
    W3 = [W_hi; W_hi; W_lo] and runs dA = sum over the 3K latents of
    tril(L3) W3^T (the dA kernel of atl_matmul, #7) and dL = tril(A_hi
    W_hi) in one pass (#6).
    """

    @staticmethod
    def forward(ctx, A, L, split):
        ctx.split = split
        with span("mgp.atl_sq_colsum.fwd", A, "op"):
            if not split:
                A16 = A.to(torch.bfloat16).contiguous()
                L16 = L.to(torch.bfloat16).contiguous()
                B16 = tril_sq_fwd(A16, L16)
                ctx.save_for_backward(A16, L16, B16)
                return B16.float().square().sum(-1)
            K = L.shape[0]
            A2, L3 = _split_operands(A, L)
            B, extra = tril_sq_fwd_split(A2, L3[:2 * K])
        ctx.save_for_backward(A2[0], L3, B)
        return extra

    @staticmethod
    def backward(ctx, gbar):
        A16, L16, B = ctx.saved_tensors
        with span("mgp.atl_sq_colsum.bwd", gbar, "op"):
            G = (2.0 * gbar).float().contiguous()
            if not ctx.split:
                dA = tril_sq_da(L16, B, G) if ctx.needs_input_grad[0] else None
                dL = tril_sq_dl(A16, B, G) if ctx.needs_input_grad[1] else None
                return dA, dL, None
            K, N, M = B.shape
            W3 = torch.empty((3 * K, N, M), dtype=torch.bfloat16,
                             device=B.device)
            split_bf16(B * G[:, :, None], W3[K:].view(2, K, N, M))
            W3[:K].copy_(W3[K:2 * K])
            dA = tril_da(L16, W3) if ctx.needs_input_grad[0] else None
            dL = tril_dl(A16, W3[:K]) if ctx.needs_input_grad[1] else None
        return dA, dL, None


def atl_sq_colsum(A, L, split=False):
    """extra[k, n] = sum_m' (A^T tril L_k)[n, m']^2: A [M, N], L [K, M, M]
    (lower triangle read) -> [K, N] fp32, with its gradient through the dL /
    dA kernels (dA returned as fp32).  B is held in bf16 from one bf16 pass,
    or with ``split`` taken in f32 from three (dA by three passes too)."""
    return _AtlSqColsum.apply(A, L, bool(split))


class _AtlMatmul(torch.autograd.Function):
    """pallas_tril.atl_matmul's custom VJP (:358-377): the forward keeps
    (A16, L16); the backward casts the cotangent once, W16 = bf16(dB), and
    runs the dL / dA kernels on it."""

    @staticmethod
    def forward(ctx, A, L):
        with span("mgp.atl_matmul.fwd", A, "op"):
            A16 = A.to(torch.bfloat16).contiguous()
            L16 = L.to(torch.bfloat16).contiguous()
            ctx.save_for_backward(A16, L16)
            return tril_fwd_f32(A16, L16)

    @staticmethod
    def backward(ctx, Bbar):
        A16, L16 = ctx.saved_tensors
        with span("mgp.atl_matmul.bwd", Bbar, "op"):
            W16 = Bbar.to(torch.bfloat16).contiguous()
            dA = tril_da(L16, W16) if ctx.needs_input_grad[0] else None
            dL = tril_dl(A16, W16) if ctx.needs_input_grad[1] else None
        return dA, dL


def atl_matmul(A, L):
    """B = A^T tril(L) in f32 from bf16 operands: A [M, N], L [K, M, M]
    (lower triangle read) -> [K, N, M] (pallas_tril.atl_matmul: both cast
    to bf16, fp32 accumulation, an f32 B), with its gradient through the dL
    / dA kernels (dA returned as fp32, dL exactly lower-triangular)."""
    return _AtlMatmul.apply(A, L)
