"""Differentiable collectives: the port's counterparts of the ``jax.lax``
primitives the JAX package's ``shard_map`` programs use (``all_gather``,
``psum``, ``psum_scatter``, ``ppermute``), each an autograd Function over a
``torch.distributed`` process group.

Gradient convention: the sum over ranks, as DistributedDataParallel has it.
Each rank calls ``backward`` on its *share* of the global scalar, and the
shares of all ranks of the group add up to it.  A value that is the same on
every rank (replicated) is shared as value / group size (``share``); a
value that differs by rank (varying) is its own share.  Each Function's
backward is the adjoint of its forward taken as a linear map over the
stacked ranks:

- ``psum`` (an all-reduce sum): the cotangents of all ranks summed;
- ``all_gather``: a summing reduce-scatter of the cotangent;
- ``psum_scatter`` (a summing reduce-scatter): an all-gather;
- ``ppermute``: the cotangent sent back along the inverse permutation.

So a rank's ``.grad`` is its part of the global gradient: a leaf that is
sharded over the group (each rank holds a different block) gets its whole
gradient, and a replicated leaf gets its rank's part, which one all-reduce
sum over the group completes.  This differs from JAX's transposes under
``shard_map`` (there a replicated cotangent is counted once and ``psum``
transposes to a broadcast); the gradients of the global scalar are the
same.  ``torch.distributed.nn.functional`` is not used: its collectives
differ from one another in which of the two conventions their backward
follows.

Every Function takes a process group (a ``DeviceMesh`` axis's group, see
``mesh.axis_group``) and works on any tensor of the group's backend: CPU
tensors on gloo, CUDA tensors on NCCL.

Each call of a torch.distributed collective here, forward or pullback, is
a span ``mgp.dist.comm.<collective>`` (kind ``mgp.dist.comm``), and adds
the bytes this rank sends, counted from the shapes as NCCL's ring
algorithms send them, to the counter ``mgp.dist.sent.<collective>``
(utils/profiling: both only while a torch profiler records).  Over P ranks
and an input x of b bytes: all_gather (P - 1) b, reduce_scatter
b (P - 1) / P, all_reduce 2 b (P - 1) / P, ppermute b to each other rank
it sends to.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..utils.profiling import count, span

__all__ = ["all_gather", "psum", "psum_scatter", "ppermute", "psum_",
           "share", "ring_perm"]


def _traffic(collective: str, x: torch.Tensor, sent: int):
    """The span of one collective call, its bytes sent counted."""
    count(f"mgp.dist.sent.{collective}", sent)
    return span(f"mgp.dist.comm.{collective}", x, "mgp.dist.comm")


def _bytes(x: torch.Tensor) -> int:
    return x.numel() * x.element_size()


def _gather0(x: torch.Tensor, group) -> torch.Tensor:
    """[P * n, ...] from each rank's [n, ...], in group-rank order (the
    single-tensor all-gather under its newer name where torch has it)."""
    size = dist.get_world_size(group)
    out = x.new_empty((size * x.shape[0], *x.shape[1:]))
    gather = (getattr(dist, "all_gather_single", None)
              or dist.all_gather_into_tensor)
    with _traffic("all_gather", x, (size - 1) * _bytes(x)):
        gather(out, x.contiguous(), group=group)
    return out


def _scatter0(x: torch.Tensor, group) -> torch.Tensor:
    """This rank's [n, ...] block of the sum over ranks of [P * n, ...]."""
    size = dist.get_world_size(group)
    out = x.new_empty((x.shape[0] // size, *x.shape[1:]))
    scatter = (getattr(dist, "reduce_scatter_single", None)
               or dist.reduce_scatter_tensor)
    with _traffic("reduce_scatter", x, (size - 1) * _bytes(x) // size):
        scatter(out, x.contiguous(), op=dist.ReduceOp.SUM, group=group)
    return out


def psum_(x: torch.Tensor, group) -> torch.Tensor:
    """``x`` (contiguous) summed over the group's ranks in place, outside
    autograd (a gradient's completion); returns ``x``."""
    size = dist.get_world_size(group)
    with _traffic("all_reduce", x, 2 * (size - 1) * _bytes(x) // size):
        dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)
    return x


def _summed(x: torch.Tensor, group) -> torch.Tensor:
    return psum_(x.clone(memory_format=torch.contiguous_format), group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _gather0(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return (_scatter0(g.movedim(ctx.dim, 0), ctx.group)
                .movedim(0, ctx.dim), None, None)


class _PSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _summed(x, group)

    @staticmethod
    def backward(ctx, g):
        return _summed(g, ctx.group), None


class _PSumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return _scatter0(x.movedim(dim, 0), group).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        return (_gather0(g.movedim(ctx.dim, 0), ctx.group)
                .movedim(0, ctx.dim), None, None)


def _permute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """Send x from each source to its destination (group ranks); a rank
    that is no pair's destination gets zeros, as jax.lax.ppermute gives."""
    me = dist.get_rank(group)
    x = x.contiguous()
    out = torch.zeros_like(x)
    ops, sends = [], 0
    for src, dst in perm:
        if src == me == dst:
            out.copy_(x)
        elif src == me:
            sends += 1
            ops.append(dist.P2POp(dist.isend, x,
                                  dist.get_global_rank(group, dst), group))
        elif dst == me:
            ops.append(dist.P2POp(dist.irecv, out,
                                  dist.get_global_rank(group, src), group))
    if ops:
        with _traffic("ppermute", x, sends * _bytes(x)):
            for work in dist.batch_isend_irecv(ops):
                work.wait()
    return out


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group, ctx.perm = group, perm
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(dst, src) for src, dst in ctx.perm]
        return _permute(g, ctx.group, inverse), None, None


def all_gather(x: torch.Tensor, group, *, dim: int = 0,
               tiled: bool = True) -> torch.Tensor:
    """Every rank's ``x`` in group-rank order: concatenated along ``dim``
    (``tiled``, jax.lax.all_gather(tiled=True)) or stacked on a new leading
    axis."""
    if not tiled:
        return _AllGather.apply(x.unsqueeze(0), group, 0)
    return _AllGather.apply(x, group, dim % x.ndim)


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``x`` over the group's ranks, on every rank."""
    return _PSum.apply(x, group)


def psum_scatter(x: torch.Tensor, group, *, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum of ``x`` over the group
    (jax.lax.psum_scatter(tiled=True)); ``x.shape[dim]`` is a multiple of
    the group's size."""
    return _PSumScatter.apply(x, group, dim % x.ndim)


def ppermute(x: torch.Tensor, group, perm) -> torch.Tensor:
    """jax.lax.ppermute: ``perm`` lists (source, destination) pairs of
    group ranks, each rank a source once and a destination once at most."""
    return _PPermute.apply(x, group, tuple(map(tuple, perm)))


def ring_perm(n: int) -> tuple[tuple[int, int], ...]:
    """The ring i -> i + 1 (mod n)."""
    return tuple((i, (i + 1) % n) for i in range(n))


def share(x: torch.Tensor, group) -> torch.Tensor:
    """A replicated value's share in the sum over ranks: x / group size."""
    return x / dist.get_world_size(group)
