"""Inducing-point (large-M) sharding: the training path with the M x M
factorization itself split over the mesh.

Mirrors modulatedgps_tpu/parallel/inducing.py:82-303.  Over one mesh axis
(default "data", P ranks) each rank holds

  Z      [M, D]     -> rows [i M / P, (i + 1) M / P)
  q_mu   [M, K]     -> the same rows
  q_sqrt [K, M, M]  -> the same range of COLUMNS: [K, M, M / P]
  X, Y   [N, ...]   -> its batch rows (shard_batch)

and the kernel hyperparameters and the likelihood replicated.  Each rank
runs the whitened conditional's program with its collectives explicit,
keeping A = L^-1 Kmn split by batch columns so that no collective's payload
grows with N:

  Zg   = all_gather(Z)                      [M, D]
  L    = blocked._chol_local(K(Z_loc, Zg) + jitter)   rows [M / P, M]
  Lg   = all_gather(L)                      [M, M]
  A    = solve_lower(Lg, K(Zg, X_loc))      [M, N / P]: the full-M TRSM (#2)
  fmean= A^T all_gather(q_mu)               [N / P, K]
  fvar = Kdiag - colsum A^2 + quad_ring(Lq, A)

The q_sqrt quadratic sum_p (Lq^T A)^2[p, n] couples every global column p
with every local batch column: the column blocks of Lq travel around a
``ppermute`` ring in P - 1 steps, each rank adding its columns' partial
sums for the visiting block.  The block of owner j is zero above global row
j M / P, so each turn's products run over the rows below it alone: over a
rank's P turns (P + 1) / (2 P) of the full products.  On the card the
ring's transfers run on a side stream, each sent on before the turn's
products, so a rank runs its turns back to back and waits only for each
block's arrival.  Payload per rank K M^2 (P - 1) / P a layer, forward and
backward, whatever N: whole blocks.  Its products are plain fp32 matmuls
(TF32 is off package-wide), as JAX leaves the einsum to XLA.  The whitened
KL is exact on the same layout: ||q_mu||^2 over rows, ||tril(q_sqrt)||^2
over columns, the log-diagonal at local column p == global row i M / P + p;
it stays plain sums (kernels #12/#13 take a whole lower-triangular
[K, M, M], which a column block is not).

A sharded layer is a ``ShardedSVGP`` holding the local blocks; its
replicated methods (``predict_f``, ``prior_kl``) refuse to run.  The global
lower-triangle mask is applied to the raw q_sqrt block here (a ``tril``
transform would take the local block's own indices).  So the block's
Parameter keeps the ``tril`` transform only where it is the whole matrix
(one rank), where ``Adam`` runs kernel #14 on it; with more ranks it is an
identity leaf and ``Adam`` takes the dense update, whose zero gradient
above the global diagonal leaves those entries and their moments 0.

Gradients follow the sum over ranks (collectives.py): each rank takes the
backward of loss / P; the sharded leaves' gradients come out whole, and one
all-reduce over the axis completes the replicated leaves'.  whiten=True and
a [K, M, M] tril q_sqrt only, as the JAX package's: the unwhitened second
solve would need a distributed backward substitution.
"""
from __future__ import annotations

import copy

import torch
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from ..config import default_jitter
from ..models.svgp import SVGP
from ..ops.linalg import solve_lower
from ..params import Parameter
from ..utils.profiling import region, span
from .blocked import _check, _chol_local
from .collectives import all_gather, ppermute, psum, psum_, ring_perm, share
from .mesh import axis_group

__all__ = [
    "ShardedSVGP",
    "inducing_specs",
    "inducing_shard_state",
    "inducing_gather_state",
    "inducing_sharded_elbo",
    "inducing_sharded_elbo_from_noise",
    "inducing_sharded_predict_f",
    "make_inducing_sharded_train_step",
]


# ----------------------------------------------------------------- placement

def _spec_for(name: str, ndim: int, axis: str) -> tuple:
    """The placement of one leaf, as the entries of a JAX PartitionSpec:
    (axis, None) for Z [M, D] and q_mu [M, K], (None, None, axis) for a
    [K, M, M] q_sqrt, () (replicated) for everything else."""
    parts = name.split(".")
    if ("Z" in parts or "q_mu" in parts) and ndim == 2:
        return (axis, None)
    if "q_sqrt" in parts and ndim == 3:
        return (None, None, axis)
    return ()


def inducing_specs(model: nn.Module, axis: str = "data") -> dict[str, tuple]:
    """{parameter name: its placement} with the inducing state sharded (the
    module docstring) and everything else replicated."""
    return {name: _spec_for(name, p.ndim, axis)
            for name, p in model.named_parameters()}


def _check_layer(layer) -> None:
    if not layer.whiten:
        raise NotImplementedError(
            "inducing-sharded conditional supports whiten=True only")
    if layer.q_sqrt.raw.ndim != 3 or (
            not isinstance(layer, ShardedSVGP)
            and layer.q_sqrt.transform != "tril"):
        raise NotImplementedError(
            "inducing-sharded conditional needs a [K, M, M] tril q_sqrt")
    if layer.mean_function is not None:
        raise NotImplementedError(
            "inducing-sharded conditional has no mean function")


class ShardedSVGP(SVGP):
    """An SVGP layer holding this rank's block of the inducing state: Z
    and q_mu rows [M / P, .], q_sqrt columns [K, M, M / P] (raw, unmasked);
    the kernel is replicated.  ``index`` is the rank's place on the axis,
    ``nshards`` the axis's size, ``num_inducing`` the global M."""

    def __init__(self, layer: SVGP, index: int, nshards: int):
        _check_layer(layer)
        M = layer.Z.shape[0]
        if M % nshards:
            raise ValueError(f"M={M} must be a multiple of the axis size "
                             f"{nshards}")
        rpd = M // nshards
        rows = slice(index * rpd, (index + 1) * rpd)

        def part(param: Parameter, raw, transform=None) -> Parameter:
            return Parameter(raw.detach().clone(), transform or param.transform,
                             param.trainable)

        q_sqrt = layer.q_sqrt
        super().__init__(
            copy.deepcopy(layer.kernel), part(layer.Z, layer.Z.raw[rows]),
            part(layer.q_mu, layer.q_mu.raw[rows]),
            part(q_sqrt, q_sqrt.raw[:, :, rows],
                 "tril" if nshards == 1 else "identity"),
            whiten=True, jitter=layer.jitter)
        self.index, self.nshards, self._M = index, nshards, M

    @property
    def num_inducing(self) -> int:
        return self._M

    def _replicated(self, *args, **kwargs):
        raise NotImplementedError(
            "a ShardedSVGP holds one rank's block: use "
            "inducing_sharded_predict_f / inducing_sharded_elbo, or "
            "inducing_gather_state for the whole layer")

    predict_f = prior_kl = kuu = predict_f_samples = _replicated


def _layers(model: nn.Module):
    return [(name, child) for name, child in model.named_children()
            if isinstance(child, SVGP)]


def _with_layers(model: nn.Module, layers: dict) -> nn.Module:
    """A copy of the model (an SGP / SMGP) with ``layers`` set and every
    other child copied, so that it shares no parameter with the model."""
    out = model.replace(**layers)
    for name, child in list(out.named_children()):
        if name not in layers:
            setattr(out, name, copy.deepcopy(child))
    return out


def inducing_shard_state(mesh: DeviceMesh, model: nn.Module,
                         axis: str = "data") -> nn.Module:
    """A copy of ``model`` (an SGP / SMGP) whose SVGP layers are this rank's
    ShardedSVGP blocks and whose other leaves are replicated as given.
    Build the optimizer on the copy."""
    _, index, size = axis_group(mesh, axis)
    return _with_layers(model, {name: ShardedSVGP(layer, index, size)
                                for name, layer in _layers(model)})


@torch.no_grad()
def _gather_layer(layer: ShardedSVGP, group) -> SVGP:
    gather = lambda t, dim: all_gather(t.detach().contiguous(), group,
                                       dim=dim)
    q_sqrt = Parameter(gather(layer.q_sqrt.raw, -1), "tril",
                       layer.q_sqrt.trainable)
    return SVGP(copy.deepcopy(layer.kernel),
                Parameter(gather(layer.Z.raw, 0), layer.Z.transform,
                          layer.Z.trainable),
                Parameter(gather(layer.q_mu.raw, 0), layer.q_mu.transform,
                          layer.q_mu.trainable),
                q_sqrt, whiten=True, jitter=layer.jitter)


def inducing_gather_state(mesh: DeviceMesh, model: nn.Module,
                          axis: str = "data") -> nn.Module:
    """The inverse of inducing_shard_state, on every rank: a whole model
    with plain SVGP layers (q_sqrt a tril leaf), for comparisons and
    checkpoints."""
    group = axis_group(mesh, axis)[0]
    return _with_layers(model, {name: _gather_layer(layer, group)
                                for name, layer in _layers(model)
                                if isinstance(layer, ShardedSVGP)})


# ------------------------------------------------------- local-shard program

def _local_leaves(layer, index: int, nshards: int):
    """(Z rows, q_mu rows, raw q_sqrt columns) of this rank: a ShardedSVGP's
    own, or slices of a replicated SVGP's (whose gradients then land in
    this rank's block of each leaf)."""
    _check_layer(layer)
    if isinstance(layer, ShardedSVGP):
        return layer.Z.value, layer.q_mu.value, layer.q_sqrt.raw
    rpd = layer.Z.shape[0] // nshards
    rows = slice(index * rpd, (index + 1) * rpd)
    return (layer.Z.value[rows], layer.q_mu.value[rows],
            layer.q_sqrt.raw[:, :, rows])


def _quad_ring(Lq_loc, A_loc, *, group, index: int, nshards: int):
    """extra[k, n] = sum over ALL global columns p of (Lq[:, :, p]^T a_n)^2
    for this rank's batch columns a_n: the column blocks of the masked Lq
    rotate around a ppermute ring.  Each turn's products run over the rows
    at and below the visiting block's first global column (the rows above
    are the global mask's zeros, and are never read), (P + 1) / (2 P) of the
    full products over a rank's P turns.  On the card the transfers run on a
    stream of their own, so that a turn waits only for its own block and
    never for the neighbours' products.  Payload per rank (P - 1) / P K M^2
    each way, whatever N: whole blocks, as the full products sent them.
    Spans mgp.dist.ring.fwd / .bwd."""
    return region("mgp.dist.ring", _ring, Lq_loc, A_loc, group=group,
                  index=index, nshards=nshards)


def _ring(Lq_loc, A_loc, *, group, index: int, nshards: int):
    keep = torch.is_grad_enabled() and (Lq_loc.requires_grad
                                        or A_loc.requires_grad)
    return _Ring.apply(Lq_loc, A_loc, group, index, nshards, keep)


_SIDE: dict = {}


def _side_stream(t: torch.Tensor, nshards: int):
    """The stream the ring's transfers and cotangent sums run on, one a
    card; None on the CPU (gloo runs each transfer to its end on the host)
    and on one rank (nothing travels)."""
    if not t.is_cuda or nshards == 1:
        return None
    if t.device not in _SIDE:
        _SIDE[t.device] = torch.cuda.Stream(t.device)
    return _SIDE[t.device]


def _first_row(index: int, turn: int, nshards: int, rpd: int) -> int:
    """The first non-zero row of the block a rank holds at ``turn``: that
    of owner (index - turn) mod P, whose columns start there."""
    return (index - turn) % nshards * rpd


class _Ring(torch.autograd.Function):
    """The ring of _quad_ring.  At turn s the rank holds owner j's block,
    r0 = j M / P; it sends the block on before the turn's product
    W^T A_loc[r0:] (W: the block's rows r0: as [K M / P, M - r0], kept for
    the pullback), and the turn waits for that block's arrival alone.  The
    pullback computes each turn's block cotangent and A_loc's share on the
    compute stream, and the reverse ring adds the turns' cotangents and
    sends them back on the side stream.  Tensors that cross the streams are
    recorded on the stream that reads them.  On the CPU the same calls run
    in the same order, each transfer to its end."""

    @staticmethod
    def forward(ctx, Lq_loc, A_loc, group, index, nshards, keep):
        K, M, rpd = Lq_loc.shape
        side = _side_stream(Lq_loc, nshards)
        compute = (torch.cuda.current_stream(Lq_loc.device) if side
                   else None)
        ctx.group, ctx.index, ctx.nshards = group, index, nshards
        ctx.turns = []
        extra = A_loc.new_zeros((K, A_loc.shape[1]))
        blk = Lq_loc.contiguous()
        if side is not None:
            side.wait_stream(compute)
            blk.record_stream(side)
        for s in range(nshards):
            r0 = _first_row(index, s, nshards, rpd)
            if s < nshards - 1:
                with torch.cuda.stream(side):
                    nxt = ppermute(blk, group, ring_perm(nshards))
                    arrived = side.record_event() if side else None
            # [K M / P, M - r0] @ [M - r0, N / P]: one fp32 matmul.
            W = blk[:, r0:].transpose(1, 2).reshape(K * rpd, M - r0)
            lta = W @ A_loc[r0:]
            extra += lta.view(K, rpd, -1).square().sum(1)
            if keep:
                ctx.turns.append((W, lta))
            if s < nshards - 1:
                if side is not None:
                    compute.wait_event(arrived)
                    nxt.record_stream(compute)
                blk = nxt
        ctx.shape = (K, M, rpd)
        ctx.save_for_backward(A_loc)
        return extra                                         # [K, N / P]

    @staticmethod
    def backward(ctx, g):
        if not ctx.turns:
            raise RuntimeError("the q_sqrt ring's pullback runs once: its "
                               "turns were freed by the first")
        (A_loc,), (K, M, rpd) = ctx.saved_tensors, ctx.shape
        group, index, nshards = ctx.group, ctx.index, ctx.nshards
        turns, ctx.turns = ctx.turns, None
        side = _side_stream(A_loc, nshards)
        compute = torch.cuda.current_stream(A_loc.device) if side else None
        back = tuple((dst, src) for src, dst in ring_perm(nshards))
        dA = torch.zeros_like(A_loc)
        held = None      # the cotangent of the block held at turn s
        for s in reversed(range(nshards)):
            W, lta = turns.pop()
            r0 = _first_row(index, s, nshards, rpd)
            G = (2 * lta.view(K, rpd, -1) * g[:, None, :]).view(K * rpd, -1)
            dW = G @ A_loc[r0:].T                            # [K M / P, M - r0]
            if side is not None:
                side.wait_stream(compute)
                dW.record_stream(side)
            with torch.cuda.stream(side):
                if held is None:
                    held = A_loc.new_zeros((K, M, rpd))
                held[:, r0:] += dW.view(K, rpd, -1).transpose(1, 2)
                if s:
                    held = ppermute(held, group, back)
            dA[r0:].addmm_(W.T, G)
            del W, lta, G, dW        # this turn's rows go before the next's
        if side is not None:
            compute.wait_stream(side)
            held.record_stream(compute)
        return held, dA, None, None, None, None


def _conditional_local(layer, X_loc, *, group, index: int, nshards: int,
                       block: int):
    """The whitened conditional with M sharded: (fmean, fvar) [N / P, K] of
    this rank's batch rows."""
    Z_loc, q_mu_loc, q_sqrt_raw = _local_leaves(layer, index, nshards)
    dtype, dev = Z_loc.dtype, Z_loc.device
    rpd = Z_loc.shape[0]
    M = q_sqrt_raw.shape[1]
    gloc = index * rpd + torch.arange(rpd, device=dev)

    Zg = all_gather(Z_loc, group)                            # [M, D]
    jitter = layer.jitter if layer.jitter is not None else default_jitter(dtype)
    eye_rows = (gloc[:, None] == torch.arange(M, device=dev)[None, :])
    Kuu_loc = layer.kernel.K(Z_loc, Zg) + jitter * eye_rows.to(dtype)
    L_loc = _chol_local(Kuu_loc, group=group, index=index, block=block)
    Lg = all_gather(L_loc, group)                            # [M, M]

    # Each rank solves the full-M TRSM for its own batch columns only:
    # M^2 N / P operations and no traffic.
    A_loc = solve_lower(Lg, layer.kernel.K(Zg, X_loc))       # [M, N / P]
    fvar0 = layer.kernel.K_diag(X_loc) - A_loc.square().sum(0)
    fmean = A_loc.T @ all_gather(q_mu_loc, group)            # [N / P, K]

    tril = (torch.arange(M, device=dev)[:, None] >= gloc[None, :]).to(dtype)
    extra = _quad_ring(q_sqrt_raw * tril, A_loc, group=group, index=index,
                       nshards=nshards)
    return fmean, fvar0[:, None] + extra.T                   # [N / P, K]


def _kl_local(layer, *, group, index: int, nshards: int) -> torch.Tensor:
    """The whitened gauss_kl of the whole layer (the same on every rank)
    from this rank's blocks: plain sums, psum'd."""
    _, q_mu_loc, q_sqrt_raw = _local_leaves(layer, index, nshards)
    K, M, rpd = q_sqrt_raw.shape
    dev, dtype = q_sqrt_raw.device, q_sqrt_raw.dtype
    gloc = index * rpd + torch.arange(rpd, device=dev)
    rows = torch.arange(M, device=dev)[:, None]
    mahal = psum(q_mu_loc.square().sum(), group)
    tril = (rows >= gloc[None, :]).to(dtype)
    trace = psum((q_sqrt_raw * tril).square().sum(), group)
    diag = (q_sqrt_raw * (rows == gloc[None, :]).to(dtype)).sum(1)   # [K, M/P]
    logdet = 2.0 * psum(diag.abs().log().sum(), group)
    return 0.5 * (mahal - M * q_mu_loc.shape[1] - logdet + trace)


# --------------------------------------------------------------- public API

def _block_for(M: int, nshards: int, block: int | None) -> int:
    return min(128, M // nshards) if block is None else block


def _program(model_or_layer, mesh, axis, block):
    """The local program's arguments; ValueError, as distributed_cholesky
    raises, where the rows of a rank are not whole panels (a panel no rank
    owns would factor as zeros)."""
    group, index, size = axis_group(mesh, axis)
    M = model_or_layer.q_sqrt.raw.shape[1]
    block = _block_for(M, size, block)
    _check(M, size, axis, block)
    return dict(group=group, index=index, nshards=size, block=block)


def inducing_sharded_elbo(model, generator: torch.Generator, X_local, Y_local,
                          mesh: DeviceMesh, *, axis: str = "data",
                          block: int | None = None) -> torch.Tensor:
    """The SMGP / SMGPModified ELBO of the global batch with the inducing
    state sharded over ``axis`` (the same value on every rank).  The model's
    layers are ShardedSVGP blocks (inducing_shard_state) or replicated
    SVGPs, sliced here.  Each rank draws the full batch's noise from the
    generator and keeps its rows."""
    n_total = X_local.shape[0] * axis_group(mesh, axis)[2]
    z, g = model.draw_noise(generator, n_total, model.num_samples,
                            X_local.dtype)
    return inducing_sharded_elbo_from_noise(model, X_local, Y_local, z, g,
                                            mesh, axis=axis, block=block)


def inducing_sharded_elbo_from_noise(model, X_local, Y_local, z, g,
                                     mesh: DeviceMesh, *, axis: str = "data",
                                     block: int | None = None) -> torch.Tensor:
    """inducing_sharded_elbo with the full batch's noise z, g [S, N, K]
    given (this rank keeps its rows)."""
    if model.num_data is None:
        raise ValueError(
            "SMGP needs num_data (total training-set size) to scale the "
            "KL term; pass num_data=N at construction.")
    for layer in (model.pred_layer, model.assign_layer):
        _check_layer(layer)
    prog = _program(model.pred_layer, mesh, axis, block)
    n_local = X_local.shape[0]
    n_total = n_local * prog["nshards"]
    if z.shape[1] != n_total:
        raise ValueError(f"noise for {z.shape[1]} points, the sharded batch "
                         f"holds {n_total}")
    rows = slice(prog["index"] * n_local, (prog["index"] + 1) * n_local)
    fmu, fvar = _conditional_local(model.pred_layer, X_local, **prog)
    amu, avar = _conditional_local(model.assign_layer, X_local, **prog)
    e = model.E_log_p_from_marginals(fmu, fvar, amu, avar, z[:, rows],
                                     g[:, rows], Y_local)
    fit = psum(e.sum(), prog["group"]) / n_total
    kl = sum(_kl_local(layer, group=prog["group"], index=prog["index"],
                       nshards=prog["nshards"])
             for layer in (model.pred_layer, model.assign_layer))
    return fit - kl / model.num_data


def inducing_sharded_predict_f(layer, Xnew_local, mesh: DeviceMesh, *,
                               axis: str = "data", block: int | None = None):
    """predict_f of one SVGP layer with its inducing state sharded: (fmean,
    fvar) [N / P, K] of this rank's rows of Xnew (shard_batch)."""
    _check_layer(layer)
    return _conditional_local(layer, Xnew_local,
                              **_program(layer, mesh, axis, block))


def make_inducing_sharded_train_step(optimizer, mesh: DeviceMesh, *,
                                     axis: str = "data",
                                     block: int | None = None):
    """step(model, generator, X_local, Y_local) -> the global loss, for a
    model placed by inducing_shard_state and the port's Adam built on it.
    The backward of loss / P runs the collectives' pullbacks (the sharded
    leaves' gradients come out whole); one all-reduce over ``axis`` sums
    the replicated leaves' gradients; Adam then updates each rank's leaves
    where they lie.  The spans are make_train_step's: ``mgp.step`` around
    ``mgp.loss``, ``mgp.backward`` (with the all-reduce) and ``mgp.adam``."""
    group = axis_group(mesh, axis)[0]
    replicated = [p for name, p in zip(optimizer.names, optimizer.params)
                  if _spec_for(name, p.ndim, axis) == ()]

    def step(model, generator, X_local, Y_local):
        if not all(isinstance(layer, ShardedSVGP)
                   for layer in (model.pred_layer, model.assign_layer)):
            raise ValueError("place the model with inducing_shard_state "
                             "and build the optimizer on it")
        with span("mgp.step", X_local):
            optimizer.zero_grad()
            with span("mgp.loss", X_local):
                loss = -inducing_sharded_elbo(model, generator, X_local,
                                              Y_local, mesh, axis=axis,
                                              block=block)
            with span("mgp.backward", X_local):
                share(loss, group).backward()
                if replicated:
                    flat = psum_(torch.cat([p.grad.reshape(-1)
                                            for p in replicated]), group)
                    at = 0
                    for p in replicated:
                        p.grad = flat[at:at + p.numel()].view_as(p)
                        at += p.numel()
            with span("mgp.adam", X_local):
                optimizer.step()
        return loss.detach()

    return step
