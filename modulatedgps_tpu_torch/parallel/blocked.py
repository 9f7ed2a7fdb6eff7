"""The distributed blocked Cholesky and forward substitution.

Mirrors modulatedgps_tpu/parallel/blocked.py:44-163.  The SPD matrix and
any right sides are split into contiguous block rows over one mesh axis
(each rank holds rows [i * M / P, (i + 1) * M / P)), and every function here
is the program one rank runs in lock step with the others, its collectives
explicit (collectives.py, with their gradients):

- ``distributed_cholesky``: right-looking, one panel of ``block`` columns
  at a time.  The owner's diagonal block is psum-broadcast and every rank
  factors it alike; each rank solves its own panel rows against it, one
  all-gather shares the panel column, and the trailing update is a local
  matmul (masked, no traffic).  Traffic per panel: block^2 psum + M * block
  all-gather.
- ``distributed_solve_lower``: blocked forward substitution; per panel the
  owner's block of the right side is psum-broadcast, solved, and folded
  into every rank's remaining rows.

The factor's forward and its backward are the spans ``mgp.dist.chol.fwd``
and ``mgp.dist.chol.bwd`` (``utils.profiling.region``), each with the
collectives inside it.

The diagonal block's factor is ``ops.linalg.cholesky`` (kernel #15 on the
card, its pullback on #2 and #10/#11) and the two solves are
``ops.linalg.solve_lower`` (#2, #4 in the pullback): no cuSOLVER or library
triangular solve runs here.  The trailing update and the fold-in stay fp32
matmuls, as JAX leaves them to XLA.  The loop over panels runs on the host:
the offsets are Python integers, the ownership a 0-dim mask, as JAX's.
"""
from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..ops.linalg import cholesky_with_inv, solve_lower
from ..utils.profiling import region
from .collectives import all_gather, psum
from .mesh import axis_group

__all__ = ["distributed_cholesky", "distributed_solve_lower"]


def _owner_block(arr_loc, j0: int, width: int, col0: int, ncols: int,
                 index: int, group):
    """The [width, ncols] block at global row j0, column col0, summed over
    the group from its owner (every other rank adds zeros).  Returns (the
    block, whether this rank owns it as a 0-dim bool tensor, the block's
    local row offset clipped into this rank's rows).

    Every rank runs the same operations whoever owns the block (a slice at
    the clipped offset, a ``where``), so the ranks' autograd graphs match
    and their backward passes call the collectives in the same order."""
    rpd = arr_loc.shape[0]
    off = j0 - index * rpd
    offc = min(max(off, 0), rpd - width)
    own = torch.full((), 0 <= off and off + width <= rpd, dtype=torch.bool,
                     device=arr_loc.device)
    blk = arr_loc[offc:offc + width, col0:col0 + ncols]
    return psum(torch.where(own, blk, 0.0), group), own, offc


def _insert(rows, blk, own, offc):
    """rows with blk written at offc where this rank owns the block."""
    n = blk.shape[0]
    return torch.cat([rows[:offc], torch.where(own, blk, rows[offc:offc + n]),
                      rows[offc + n:]])


def _chol_local(A_loc, *, group, index: int, block: int):
    """This rank's rows [M / P, M] of the lower factor of the global SPD
    matrix whose rows A_loc holds."""
    return region("mgp.dist.chol", _chol_panels, A_loc, group=group,
                  index=index, block=block)


def _chol_panels(A_loc, *, group, index: int, block: int):
    rpd, M = A_loc.shape
    grow = index * rpd + torch.arange(rpd, device=A_loc.device)
    gcol = torch.arange(M, device=A_loc.device)
    panels = []
    for j0 in range(0, M, block):
        diag, own, offc = _owner_block(A_loc, j0, block, j0, block, index,
                                       group)
        Ljj, inv = cholesky_with_inv(diag)
        # The panel rows X Ljj^T = A[:, j]: rows below the diagonal block
        # keep it, rows at or above get 0, the owner's diagonal rows Ljj.
        Pcol = A_loc[:, j0:j0 + block]
        Lpan = solve_lower(Ljj, Pcol.T, inv=inv).T
        Lpan = _insert(torch.where((grow >= j0 + block)[:, None], Lpan, 0.0),
                       Ljj, own, offc)
        # Share the panel column, then the rank-block update of the
        # trailing columns: a local matmul.
        Lcol = all_gather(Lpan, group)                       # [M, block]
        Lcol_trail = torch.where((gcol >= j0 + block)[:, None], Lcol, 0.0)
        A_loc = A_loc - Lpan @ Lcol_trail.T
        panels.append(Lpan)
    return torch.cat(panels, dim=1)


def _solve_lower_local(L_loc, B_loc, *, group, index: int, block: int):
    """This rank's rows of X for L X = B, L and B split alike by rows."""
    rpd, M = L_loc.shape
    N = B_loc.shape[-1]
    grow = index * rpd + torch.arange(rpd, device=L_loc.device)
    X_loc = torch.zeros_like(B_loc)
    for j0 in range(0, M, block):
        Ljj, own, offc = _owner_block(L_loc, j0, block, j0, block, index,
                                      group)
        Bj, _, _ = _owner_block(B_loc, j0, block, 0, N, index, group)
        Xj = solve_lower(Ljj, Bj)                            # [block, N]
        # Fold X_j into every rank's remaining rows (rows above j0 have no
        # entries in this column block; the mask keeps the consumed ones).
        upd = L_loc[:, j0:j0 + block] @ Xj
        B_loc = B_loc - torch.where((grow >= j0 + block)[:, None], upd, 0.0)
        X_loc = _insert(X_loc, Xj, own, offc)
    return X_loc


def _check(M: int, nshards: int, axis: str, block: int) -> None:
    if M % nshards:
        raise ValueError(f"M={M} must be a multiple of the '{axis}' axis "
                         f"size {nshards}")
    rpd = M // nshards
    if rpd % block:
        raise ValueError(f"rows-per-device {rpd} must be a multiple of "
                         f"block={block}")


def distributed_cholesky(A_loc: torch.Tensor, mesh: DeviceMesh, *,
                         axis: str = "data", block: int = 128) -> torch.Tensor:
    """The lower Cholesky factor of a global SPD [M, M] matrix whose rows
    [i * M / P, (i + 1) * M / P) this rank holds as ``A_loc``: the same rows
    of the factor."""
    group, index, size = axis_group(mesh, axis)
    _check(A_loc.shape[-1], size, axis, block)
    return _chol_local(A_loc, group=group, index=index, block=block)


def distributed_solve_lower(L_loc: torch.Tensor, B_loc: torch.Tensor,
                            mesh: DeviceMesh, *, axis: str = "data",
                            block: int = 128) -> torch.Tensor:
    """This rank's rows of the solution of L X = B, for a lower-triangular
    L and a right side B both split by rows as distributed_cholesky's."""
    group, index, size = axis_group(mesh, axis)
    _check(L_loc.shape[-1], size, axis, block)
    return _solve_lower_local(L_loc, B_loc, group=group, index=index,
                              block=block)
