"""The ("data", "expert") device mesh and the placement of a model on it.

Mirrors modulatedgps_tpu/parallel/mesh.py:30-96.  Each rank is a process
holding one device; the mesh is a ``torch.distributed.DeviceMesh`` whose
axes are

- "data": shards the minibatch N: each rank takes its contiguous rows
  (``shard_batch``), and the ELBO's data-fit sum and the gradients are
  all-reduced over it;
- "expert": shards the K mixture components: q_mu [M, K] on its K axis,
  a tril q_sqrt [K, M, M] on its leading axis, a diagonal q_sqrt [M, K]
  and the likelihood's per-expert variance (1, K) on their last.  Kernel
  hyperparameters and Z stay replicated.

A placed model is an ordinary module whose parameters hold this rank's
part: ``replicate_state`` copies the mesh's first rank's values into every
rank's, ``expert_shard_state`` then keeps this rank's experts of each
expert-shardable leaf.  Build the optimizer after placing the model.
When K is not a multiple of the expert axis, expert placement falls back to
replication, as the JAX package's does.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..params import Parameter
from .multihost import start_single_process

__all__ = ["make_mesh", "shard_batch", "replicate_state", "expert_shard_state",
           "axis_group", "mesh_device", "expert_dim", "expert_sharded"]

AXES = ("data", "expert")


def make_mesh(num_data: int | None = None, num_expert: int = 1,
              device="cuda") -> DeviceMesh:
    """DeviceMesh(("data", "expert")) over every rank of the job; all on
    "data" by default.  ValueError unless num_data * num_expert is the
    world size.  Without a process group (one process started without
    torchrun) it starts a group of one; the backend follows ``device``
    (multihost.backend_for)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if num_data is None:
        num_data = world // num_expert
    if num_data * num_expert != world:
        raise ValueError(f"mesh {num_data}x{num_expert} != {world} ranks")
    start_single_process(device)
    return init_device_mesh(torch.device(device).type, (num_data, num_expert),
                            mesh_dim_names=AXES)


def axis_group(mesh: DeviceMesh, axis: str):
    """(process group, this rank's index on the axis, the axis's size)."""
    group = mesh.get_group(axis)
    return group, mesh.get_local_rank(axis), dist.get_world_size(group)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_batch(mesh: DeviceMesh, *arrays):
    """This rank's contiguous rows of each array over "data" (a tensor is
    sliced where it lies; anything else becomes a tensor on the mesh's
    device).  ValueError unless N is a multiple of the axis's size."""
    _, index, size = axis_group(mesh, "data")
    out = []
    for a in arrays:
        t = a if torch.is_tensor(a) else torch.as_tensor(
            a, device=mesh_device(mesh))
        if t.shape[0] % size:
            raise ValueError(f"N={t.shape[0]} is not a multiple of the "
                             f"'data' axis size {size}")
        n = t.shape[0] // size
        out.append(t[index * n:(index + 1) * n])
    return tuple(out) if len(out) > 1 else out[0]


@torch.no_grad()
def replicate_state(mesh: DeviceMesh, model: nn.Module) -> nn.Module:
    """Copy every parameter and buffer of the mesh's first rank into this
    rank's (in place; returns the model)."""
    tensors = list(model.parameters()) + list(model.buffers())
    for axis in AXES:
        group, _, size = axis_group(mesh, axis)
        if size == 1:
            continue
        src = dist.get_global_rank(group, 0)
        for t in tensors:
            dist.broadcast(t.data, src=src, group=group)
    return model


def expert_dim(name: str, ndim: int) -> int | None:
    """The axis over which an expert-shardable leaf is split, else None
    (replicated).  By meaning, as the JAX package's _expert_spec_for:
    q_mu [M, K] -> 1; q_sqrt tril [K, M, M] -> 0, diagonal [M, K] -> 1;
    the likelihood's variance (1, K) -> 1."""
    parts = name.split(".")
    if "q_mu" in parts and ndim == 2:
        return 1
    if "q_sqrt" in parts:
        return {3: 0, 2: 1}.get(ndim)
    if "variance" in parts and "likelihood" in parts and ndim == 2:
        return 1
    return None


def expert_sharded(mesh: DeviceMesh, K: int) -> bool:
    """Whether expert placement shards (not a replication fallback)."""
    size = axis_group(mesh, "expert")[2]
    return size > 1 and K % size == 0


def expert_shard_state(mesh: DeviceMesh, model: nn.Module, K: int) -> nn.Module:
    """Replicate ``model`` over the mesh, then keep this rank's K / E
    experts of each expert-shardable leaf (in place; returns the model).
    Falls back to replication when the expert axis is 1 or does not divide
    K."""
    replicate_state(mesh, model)
    if not expert_sharded(mesh, K):
        return model
    _, index, size = axis_group(mesh, "expert")
    width = K // size
    for prefix, mod in model.named_modules():
        if not isinstance(mod, Parameter):
            continue
        dim = expert_dim(f"{prefix}.raw", mod.raw.ndim)
        if dim is None:
            continue
        local = mod.raw.detach().narrow(dim, index * width, width).clone()
        mod.raw = nn.Parameter(local, requires_grad=mod.raw.requires_grad)
    return model
